// Flash-2 causal prefill attention, GQA in the model's native layout.
//
//   O = softmax(mask(Q·Kᵀ·scale)) · V      per (batch, head), f32 out
//
// Replaces: src/repro/kernels/attn_prefill.py::attn_prefill_pallas.
//
// Semantics carried over exactly: q (b, s, nh, hd) and k/v (b, S, nkv, hd)
// bf16 stay in their stored layout; query head h reads KV head h / g (no
// expansion of K/V in memory); query i attends key j when
// 0 <= kpos[j] <= qpos[i] (-1 marks a dead row or column); the mask value is
// the finite -1e30; p is zeroed through the liveness mask; the 1/l
// normalization happens once at the end and rows with l == 0 are zero.
//
// What bounds it on an H100: at the main path's shapes (window 544,
// hd 128) the function's least time is its bytes (q, k, v, out) at the
// tensor-core rate; this first kernel does both products on the FP32 cores
// (f32 scores and probabilities, as the plain version computes them), so it
// is bound by FP32 operations instead.
//
// What the design does about it: one block per (64-query tile, head,
// batch row) gives b·nh·s/64 blocks; each thread holds a 4 x 4 score
// micro-tile and a 4 x hd/16 output micro-tile in registers, K/V tiles sit
// in shared memory as bf16 (odd word stride: conflict-free column reads),
// and a KV tile with no key inside [0, max qpos of the query tile] is
// skipped outright — exact, since such a tile leaves m, l and acc as they
// were — which drops the causal upper triangle and the dead window tail.
// Later work: bf16 tensor-core products (mma/wgmma) with an f32 softmax.
//
// Shapes: s % 64 == 0, S % 64 == 0 (the dispatch layer pads with -1
// positions); hd in {16, 32, 64, 128}.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Smem {
  static constexpr int QS = HD + 1;        // f32 row stride of the Q tile
  static constexpr int KS = HD / 2 + 1;    // bf16x2 word stride of K / V rows (odd)
  static constexpr int PS = BKV + 1;       // f32 row stride of the P tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(float) * BQ * QS;
  static constexpr size_t v = k + sizeof(uint32_t) * BKV * KS;
  static constexpr size_t p = v + sizeof(uint32_t) * BKV * KS;
  static constexpr size_t stats = p + sizeof(float) * BQ * PS;  // m, l, alpha
  static constexpr size_t pos = stats + sizeof(float) * 3 * BQ;  // qpos, kpos
  static constexpr size_t total = pos + sizeof(int) * (BQ + BKV + 1);
};

__device__ __forceinline__ float bf16_at(const uint32_t* row, int d) {
  const uint32_t w = row[d >> 1];
  return __uint_as_float((d & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, float* __restrict__ out, float scale,
                    int s, int S, int nh, int nkv) {
  using L = Smem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + L::k);
  uint32_t* vs = reinterpret_cast<uint32_t*>(smem + L::v);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(smem + L::pos);
  int* kpos_s = qpos_s + BQ;
  int* qmax_s = kpos_s + BKV;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (nh / nkv);
  constexpr int NC = HD / 16;  // output columns per thread

  // Q tile (scaled, f32), positions and running statistics
  if (tid == 0) *qmax_s = -1;
  for (int i = tid; i < BQ * HD / 2; i += THREADS) {
    const int row = i / (HD / 2), c = (i % (HD / 2)) * 2;
    const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(
        q + (((size_t)bi * s + q0 + row) * nh + h) * HD + c);
    qs[row * L::QS + c] = __bfloat162float(pr.x) * scale;
    qs[row * L::QS + c + 1] = __bfloat162float(pr.y) * scale;
  }
  if (tid < BQ) {
    qpos_s[tid] = qpos[(size_t)bi * s + q0 + tid];
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid < BQ) atomicMax(qmax_s, qpos_s[tid]);
  __syncthreads();
  const int qmax = *qmax_s;

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    if (tid < BKV) kpos_s[tid] = kpos[(size_t)bi * S + kv0 + tid];
    __syncthreads();
    const bool any_live =
        __syncthreads_or(tid < BKV && kpos_s[tid] >= 0 && kpos_s[tid] <= qmax);
    if (!any_live) continue;

    for (int i = tid; i < BKV * HD / 8; i += THREADS) {
      const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const size_t off = (((size_t)bi * S + kv0 + row) * nkv + hk) * HD + c;
      const uint4 kq = *reinterpret_cast<const uint4*>(k + off);
      const uint4 vq = *reinterpret_cast<const uint4*>(v + off);
      uint32_t* kd = ks + row * L::KS + c / 2;
      uint32_t* vd = vs + row * L::KS + c / 2;
      kd[0] = kq.x; kd[1] = kq.y; kd[2] = kq.z; kd[3] = kq.w;
      vd[0] = vq.x; vd[1] = vq.y; vd[2] = vq.z; vd[3] = vq.w;
    }
    __syncthreads();

    // scores: rows ty + 16i, columns tx + 16j
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * L::QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = bf16_at(ks + (tx + 16 * j) * L::KS, d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i, qp = qpos_s[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j, kp = kpos_s[col];
          ps[row * L::PS + col] = (kp <= qp && kp >= 0) ? sc[i][j] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 columns each
    {
      const int row = tid / 4, part = tid % 4, qp = qpos_s[row];
      float* prow = ps + row * L::PS + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kp = kpos_s[part * 16 + j];
        const float p = (kp <= qp && kp >= 0) ? expf(prow[j] - m_next) : 0.f;
        prow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // all four lanes have read m_s / l_s before lane 0 writes
      if (part == 0) {
        const float alpha = expf(m_prev - m_next);
        alpha_s[row] = alpha;
        l_s[row] = alpha * l_s[row] + sum;
        m_s[row] = m_next;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P·V
    {
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = alpha_s[ty + 16 * i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] *= al[i];
      for (int jj = 0; jj < BKV; ++jj) {
        float pv[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * L::PS + jj];
#pragma unroll
        for (int j = 0; j < NC; ++j) vv[j] = bf16_at(vs + jj * L::KS, tx + 16 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const float l = l_s[row];
    const float inv = l == 0.f ? 0.f : 1.f / l;
    float* orow = out + (((size_t)bi * s + q0 + row) * nh + h) * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kpos,
           void* out, float scale, int b, int s, int S, int nh, int nkv,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(s / BQ, nh, b);
  attn_prefill_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(out), scale, s, S, nh, nkv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos, void* out, float scale,
                                   int b, int s, int S, int nh, int nkv, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, qpos, kpos, out, scale, b, s, S, nh, nkv, st);
    case 32: return launch<32>(q, k, v, qpos, kpos, out, scale, b, s, S, nh, nkv, st);
    case 64: return launch<64>(q, k, v, qpos, kpos, out, scale, b, s, S, nh, nkv, st);
    case 128: return launch<128>(q, k, v, qpos, kpos, out, scale, b, s, S, nh, nkv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
