// LoRDS quantization step (paper Alg. 1, step 2.1), emitted packed:
//
//   S = clamp(B·A),   ratio = W ⊘ S,   code = #{ l : ratio > mid_l }
//
// i.e. the nearest codebook level of W/S (a value exactly on a midpoint
// takes the lower level, a NaN ratio code 0), written in the repository's
// pack layout: code k of a row at bit k·BITS of the row's little-endian
// byte stream.
//
// Replaces: src/repro/kernels/lut_quantize.py::lut_quantize_pallas, the QAT
// fake-quant forward's quantization (the only caller in either package: both
// PTQ paths quantize with plain `quantize_codes`).
//
// What bounds it on an H100: issue, with bytes close under it.  It reads the
// f32 master W once (4 bytes a weight) and writes BITS/8 bytes of codes:
// 0.295 ms over llama3-8b's seven linears of a layer at 3.35 TB/s.  Each
// weight also costs about 61 issued instructions at the MLP's rank 24: r
// FP32 FMAs of S and r/16 loads of B, 3 for the clamp, about 14 for the IEEE
// division (with its slow-path branch), 11 for the 4-step search, and the
// packing, the store and the ring: about 0.4-0.45 ms of issue over the layer
// on 132 SMs, so the kernel runs at issue, not at bytes.
//
// What the design does about it:
// - A CTA owns a strip of 128 columns and a run of `rows` rows (32-256, from
//   a wave model in `launch`).  A thread owns 4 columns: at r <= 32 it holds
//   their r A values in registers (template RB, the rank rounded up to 8,
//   zero-padded), loaded once; the rows stream past them.  Larger ranks keep
//   the strip of A in shared memory (RB = 0), correct at any rank that fits.
// - The run's B rows are staged once in shared memory by `cp.async` (a row
//   stride of RB floats, zero-padded) and read as float4 broadcasts: r/4
//   loads a row per thread, for 4r FMAs.  S takes r FMAs a weight in rank
//   order 0 .. r-1; each warp computes two rows a step, so eight chains of
//   FMAs, divisions and searches a thread are independent.
// - W streams through a ring of `cp.async` 16-byte copies, STAGES steps of
//   RPI rows per warp deep.  Each lane copies only the 16 bytes it
//   computes, so a lane's own wait_group is all the synchronisation the ring
//   needs: no barrier in the loop.  Two stages suffice: the kernel is not
//   waiting on bytes.
// - The search is BITS steps over the midpoints padded with +inf to
//   2^BITS - 1 entries (the wrapper's table) in shared memory:
//   code += ratio > tab[code + step - 1] ? step : 0, step = 2^(BITS-1) .. 1,
//   which counts the midpoints strictly below the ratio (NaN: 0); the first
//   step's midpoint sits in a register, the others are one load, a compare
//   and a predicated add each.
// - The division stays IEEE (`__fdiv_rn`): codes agree with the plain
//   version's W / S except where S = B·A, summed in another order, moves a
//   ratio across a midpoint it lies within a few ulps of.
//
// Shapes: K % 8 == 0; N and K otherwise free (ragged edges are masked).

#include "hopper.cuh"
#include "lords_common.cuh"

namespace {

constexpr int THREADS = 128;             // four warps
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 4;                   // columns of a thread: one float4 of a W row
constexpr int STRIP = 32 * CPT;          // columns of a CTA
constexpr int RPI = 2;                   // rows a warp computes a step
constexpr int STAGES = 2;                // ring depth, in steps: 8 KB a CTA
constexpr int STEP_ROWS = WARPS * RPI;   // rows of a CTA a step
constexpr int RING_FLOATS = WARPS * STAGES * RPI * 32 * CPT;

// the ring's copies and waits order this thread's shared-memory accesses
// (a lane reads only what it copied), so they clobber memory
__device__ __forceinline__ void copy16(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// The count of midpoints strictly below `ratio` by a BITS-step search of
// the padded table, kept as a byte offset into it (code·4) so that each step
// is one load at a register-plus-constant address, a compare and an add;
// `top` is the first step's midpoint, tab[2^(BITS-1) - 1], held in a register
template <int BITS>
__device__ __forceinline__ uint32_t search(const float* tab, float top, float ratio) {
  constexpr uint32_t HALF = 1u << (BITS - 1);
  const char* base = reinterpret_cast<const char*>(tab);
  uint32_t off = ratio > top ? 4 * HALF : 0;
#pragma unroll
  for (uint32_t step = HALF / 2; step > 0; step >>= 1) {
    const float mid = *reinterpret_cast<const float*>(base + off + 4 * (step - 1));
    asm("{\n .reg .pred p;\n setp.gt.f32 p, %1, %2;\n @p add.u32 %0, %0, %3;\n}"
        : "+r"(off) : "f"(ratio), "f"(mid), "r"(4 * step));
  }
  return off / 4;
}

// rows x B-row stride, then (RB == 0) the strip of A
__host__ __device__ constexpr int b_stride(int rb, int r) { return rb > 0 ? rb : (r + 3) / 4 * 4; }

inline size_t smem_bytes(int rb, int bits, int r, int rows) {
  const size_t tab = ((1 << bits) - 1 + 3) / 4 * 4;
  const size_t as = rb > 0 ? 0 : (size_t)r * STRIP;
  return sizeof(float) * (RING_FLOATS + tab + (size_t)rows * b_stride(rb, r) + as);
}

template <int BITS, int RB>
__global__ void __launch_bounds__(THREADS, RB > 0 && RB <= 24 ? 4 : 1)
lut_quantize_kernel(const float* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ a, const float* __restrict__ tab,
                    uint8_t* __restrict__ out, int N, int K, int r, int rows) {
  constexpr int TAB = (1 << BITS) - 1;
  extern __shared__ __align__(16) float smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float* ts = smem + RING_FLOATS;
  float* bs = ts + (TAB + 3) / 4 * 4;
  const int rs = b_stride(RB, r);
  float* as = bs + rows * rs;  // RB == 0 only

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k = blockIdx.x * STRIP + lane * CPT;
  const bool kin = k < K;  // K % 8 == 0: a thread's 4 columns are all in or all out
  const int n0 = blockIdx.y * rows;
  const int steps = rows / STEP_ROWS;
  // row j of step i is the CTA's row i·STEP_ROWS + warp·RPI + j; a lane's
  // slot for it: mine[((i % STAGES)·RPI + j)·32]
  const float4* mine = ring + warp * STAGES * RPI * 32 + lane;
  const uint32_t mine_s = hopper::smem_u32(mine);
  const float* src = w + (size_t)(n0 + warp * RPI) * K + k;  // step `next`'s first row
  int next = 0;
  auto issue = [&]() {
    if (next < steps) {
      const int n = n0 + next * STEP_ROWS + warp * RPI;
#pragma unroll
      for (int j = 0; j < RPI; ++j)
        copy16(mine_s + ((next % STAGES) * RPI + j) * 512, kin && n + j < N ? src + j * K : w,
               kin && n + j < N);
      src += (size_t)STEP_ROWS * K;
    }
    ++next;
    commit();  // an empty group past the last step keeps the wait count
  };
  // the run's B rows (zero-padded to a row stride of rs floats) and, at
  // RB == 0, the strip of A: one group of copies ahead of the ring's
  if (r == rs) {  // the run's rows·r floats are contiguous: 16-byte copies
    for (int i = tid; i < rows * r / 4; i += THREADS) {
      const bool ok = n0 + 4 * i / r < N;
      copy16(hopper::smem_u32(bs + 4 * i), ok ? b + (size_t)n0 * r + 4 * i : b, ok);
    }
  } else {
    for (int i = tid; i < rows * rs; i += THREADS) {
      const int row = i / rs, rr = i - row * rs, n = n0 + row;
      const bool ok = rr < r && n < N;
      copy4(bs + i, ok ? b + (size_t)n * r + rr : b, ok);
    }
  }
  if constexpr (RB == 0) {
    const int k0 = blockIdx.x * STRIP;
    for (int i = tid; i < r * (STRIP / CPT); i += THREADS) {
      const int rr = i / (STRIP / CPT), c = k0 + (i % (STRIP / CPT)) * CPT;
      copy16(hopper::smem_u32(as + 4 * i), c < K ? a + (size_t)rr * K + c : a, c < K);
    }
  }
  commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue();

  for (int i = tid; i < TAB; i += THREADS) ts[i] = tab[i];
  constexpr int RA = RB > 0 ? RB : 1;
  float areg[RA][CPT];
  if constexpr (RB > 0) {
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < r && kin) v = __ldg(reinterpret_cast<const float4*>(a + (size_t)rr * K + k));
      areg[rr][0] = v.x, areg[rr][1] = v.y, areg[rr][2] = v.z, areg[rr][3] = v.w;
    }
  }
  wait_ring();  // the oldest group, B (and A), has landed
  __syncthreads();
  const float top = ts[(1 << (BITS - 1)) - 1];

  const size_t row_bytes = (size_t)K / 8 * BITS;
  uint8_t* dst = out + (size_t)(n0 + warp * RPI) * row_bytes + (size_t)k * BITS / 8;
  for (int i = 0; i < steps; ++i, dst += STEP_ROWS * row_bytes) {
    issue();
    wait_ring();  // this lane's copies of step i have landed
    // S of the step's RPI rows, their ratios, then the searches: the
    // RPI·CPT chains of each phase are independent and overlap
    const int nl0 = i * STEP_ROWS + warp * RPI;
    float s[RPI][CPT] = {};
    if constexpr (RB > 0) {
#pragma unroll
      for (int q = 0; q < RB / 4; ++q)
#pragma unroll
        for (int j = 0; j < RPI; ++j) {
          const float4 b4 = reinterpret_cast<const float4*>(bs + (nl0 + j) * RB)[q];
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int c = 0; c < CPT; ++c) s[j][c] = fmaf(bv[t], areg[4 * q + t][c], s[j][c]);
        }
    } else {
      for (int rr = 0; rr < r; ++rr) {
        const float4 a4 = reinterpret_cast<const float4*>(as)[rr * (STRIP / CPT) + lane];
#pragma unroll
        for (int j = 0; j < RPI; ++j) {
          const float bv = bs[(nl0 + j) * rs + rr];
          s[j][0] = fmaf(bv, a4.x, s[j][0]), s[j][1] = fmaf(bv, a4.y, s[j][1]);
          s[j][2] = fmaf(bv, a4.z, s[j][2]), s[j][3] = fmaf(bv, a4.w, s[j][3]);
        }
      }
    }
    float ratio[RPI][CPT];
#pragma unroll
    for (int j = 0; j < RPI; ++j) {
      const float4 w4 = mine[((i % STAGES) * RPI + j) * 32];
      const float wv[CPT] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int c = 0; c < CPT; ++c) ratio[j][c] = __fdiv_rn(wv[c], lords::clamp_scale(s[j][c]));
    }
#pragma unroll
    for (int j = 0; j < RPI; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) word |= search<BITS>(ts, top, ratio[j][c]) << (c * BITS);

      // this thread's 4 codes sit at bit k·BITS of row n: byte k·BITS/8
      const int n = n0 + nl0 + j;
      uint8_t* d = dst + j * row_bytes;
      if constexpr (BITS == 3) {
        // two lanes' 12 bits make one 3-byte group of 8 codes
        const uint32_t pair = word | __shfl_down_sync(0xffffffffu, word, 1) << 12;
        if (n < N && kin && lane % 2 == 0)
          d[0] = (uint8_t)pair, d[1] = (uint8_t)(pair >> 8), d[2] = (uint8_t)(pair >> 16);
      } else if (n < N && kin) {
        if constexpr (BITS == 8) *reinterpret_cast<uint32_t*>(d) = word;
        if constexpr (BITS == 4) *reinterpret_cast<uint16_t*>(d) = (uint16_t)word;
        if constexpr (BITS == 2) *d = (uint8_t)word;
      }
    }
  }
}

// Rows a CTA runs: the candidate of least modelled time, whole waves of
// CTAs (resident CTAs per SM from the occupancy of each candidate's shared
// memory) times the run plus a set-up worth 16 rows.  A constant 128 ran
// wk/wv (N = 1024, half a wave of CTAs) 17% slower than the model's 64
template <int BITS, int RB>
int pick_rows(int N, int K, int r, int sms) {
  static int occupancy[4] = {-1, -1, -1, -1};  // per candidate; r fixes it when RB > 0
  const int cands[4] = {32, 64, 128, 256};
  const long strips = (K + STRIP - 1) / STRIP;
  int best = 0;
  double best_t = 0.0;
  for (int c = 0; c < (RB > 0 ? 4 : 2); ++c) {
    const int rows = cands[c];
    const size_t smem = smem_bytes(RB, BITS, r, rows);
    if (smem > 227 * 1024) break;
    int occ = RB > 0 ? occupancy[c] : -1;
    if (occ < 0) {
      if (lords::allow_smem(lut_quantize_kernel<BITS, RB>, smem) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, lut_quantize_kernel<BITS, RB>,
                                                        THREADS, smem) != cudaSuccess)
        return 0;
      if (RB > 0) occupancy[c] = occ;
    }
    if (occ < 1) break;
    const long ctas = strips * ((N + rows - 1) / rows), slots = (long)sms * occ;
    const double t = (double)((ctas + slots - 1) / slots) * (rows + 16);
    if (best == 0 || t < best_t) best = rows, best_t = t;
  }
  return best;
}

template <int BITS, int RB>
int launch(const void* w, const void* b, const void* a, const void* tab, void* out, int N,
           int K, int r, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int rows = pick_rows<BITS, RB>(N, K, r, sms);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(RB, BITS, r, rows);
  err = lords::allow_smem(lut_quantize_kernel<BITS, RB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((K + STRIP - 1) / STRIP, (N + rows - 1) / rows);
  lut_quantize_kernel<BITS, RB><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(tab), static_cast<uint8_t*>(out), N, K, r, rows);
  return cudaGetLastError();
}

template <int BITS>
int launch_rank(const void* w, const void* b, const void* a, const void* tab, void* out, int N,
                int K, int r, cudaStream_t st) {
  if (r <= 8) return launch<BITS, 8>(w, b, a, tab, out, N, K, r, st);
  if (r <= 16) return launch<BITS, 16>(w, b, a, tab, out, N, K, r, st);
  if (r <= 24) return launch<BITS, 24>(w, b, a, tab, out, N, K, r, st);
  if (r <= 32) return launch<BITS, 32>(w, b, a, tab, out, N, K, r, st);
  return launch<BITS, 0>(w, b, a, tab, out, N, K, r, st);
}

}  // namespace

// tab: the codebook's level midpoints padded with +inf to n_mids = 2^bits - 1
// entries (kernels/lut_quantize.py's device_table)
extern "C" int lut_quantize_launch(const void* w, const void* b, const void* a,
                                   const void* tab, void* out, int N, int K, int r, int bits,
                                   int n_mids, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || r < 0 || n_mids != (1 << bits) - 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || K == 0) return static_cast<int>(cudaSuccess);
  switch (bits) {
    case 2: return launch_rank<2>(w, b, a, tab, out, N, K, r, st);
    case 3: return launch_rank<3>(w, b, a, tab, out, N, K, r, st);
    case 4: return launch_rank<4>(w, b, a, tab, out, N, K, r, st);
    case 8: return launch_rank<8>(w, b, a, tab, out, N, K, r, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
