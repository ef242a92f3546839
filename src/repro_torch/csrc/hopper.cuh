// Hopper (sm_90a) building blocks shared by the LoRDS dequant-matmul and
// gradient kernels, the decode GEMVs and the attention kernels: cp.async
// copies, the `mma.sync` bf16 and tf32 products, the split of f32 into bf16
// hi / lo parts and the MUFU 2^x, mbarriers and TMA tile loads, the tf32
// split, shared-memory matrix descriptors (K-major and MN-major), wgmma
// fences and the wgmma shapes they issue, 3xTF32 S (64 x 64 and 64 x 32),
// and the pre-pass that splits B and A into tf32 hi / lo parts for it.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory; the `bytes` read from src are zero-extended
// (0: the 16 bytes are zero-filled)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// 4 bytes to shared memory, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d (16 x 8, f32) += a (16 x 16, bf16) · b (16 x 8, bf16): `mma.sync`
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) += a (16 x 8, tf32) · b (8 x 8, tf32): `mma.sync`; the
// operands are tf32 bit patterns (see split_tf32).  Not volatile: the
// compiler may interleave it with independent work.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, to 2 ulp (the MUFU unit); 2^(-huge) and 2^(-inf) are 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (x0, x1) -> bf16 pairs hi and lo with x ≈ hi + lo to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both tf32: the 3xTF32 split of an f32 operand
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte rows
// and the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Descriptor of a K-major tf32 tile without swizzle: 8-row x 16-byte core
// matrices, 8-row groups 128 bytes apart, K-adjacent ones `lbo` bytes apart.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, f32) (+)= da (64 x 8 tf32) · db (64 x 8 tf32), both K-major in
// shared memory; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) (+)= da (64 x 8 tf32) · db (32 x 8 tf32), both K-major in
// shared memory; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 16 bf16, registers) · db (128 x 16, K-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Descriptor of an MN-major (transposed) bf16 tile under the 128-byte
// swizzle, as a TMA box of 64 columns lays it out: each row of the depth
// axis holds 64 elements of the MN axis in 128 bytes, 8-row groups lie 1024
// bytes apart (the stride byte offset), and the next 64 elements of the MN
// axis, where the operand has more, `lbo` bytes on (the leading byte
// offset).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, f32) += a (64 x 16) · b (16 x 256), both bf16 from shared
// memory and both transposed (MN-major: see mn_desc): a is the 64-row side
// of the product, b its 256 columns, the depth 16 their shared outer axis.
__device__ __forceinline__ void wgmma_m64n256k16_tt(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// S (64 x 64, f32) = U·V at f32 accuracy, the rank r = 8·r8 the depth:
// 3xTF32 wgmma m64n64k8 over it in chunks of 8 (U_lo·V_hi + U_hi·V_lo +
// U_hi·V_hi), issued and committed, not waited for.  uh / ul: U's 64 rows
// split into tf32 hi / lo parts in the pre-pass layout, rank groups of 4
// `ulbo` bytes apart; vh / vl: V's 64 columns, rank groups `vlbo` apart.
// The forward kernels pass B's rows as U and A's columns as V, the
// transposed ones A as U and B as V.
__device__ __forceinline__ void s_3xtf32(float (&sacc)[32], uint32_t uh, uint32_t ul,
                                         uint32_t ulbo, uint32_t vh, uint32_t vl, uint32_t vlbo,
                                         int r8) {
  wgmma_fence();
  for (int c = 0; c < r8; ++c) {
    const uint32_t uo = 2 * c * ulbo, vo = 2 * c * vlbo;
    wgmma_m64n64k8_tf32(sacc, tf32_desc(ul + uo, ulbo), tf32_desc(vh + vo, vlbo),
                        c > 0);  // c == 0 starts S at 0
    wgmma_m64n64k8_tf32(sacc, tf32_desc(uh + uo, ulbo), tf32_desc(vl + vo, vlbo), 1);
    wgmma_m64n64k8_tf32(sacc, tf32_desc(uh + uo, ulbo), tf32_desc(vh + vo, vlbo), 1);
  }
  wgmma_commit();
}

// S (64 x 32) = U·V as s_3xtf32, on m64n32k8: V's 32 columns, rank groups
// `vlbo` bytes apart.
__device__ __forceinline__ void s_3xtf32(float (&sacc)[16], uint32_t uh, uint32_t ul,
                                         uint32_t ulbo, uint32_t vh, uint32_t vl, uint32_t vlbo,
                                         int r8) {
  wgmma_fence();
  for (int c = 0; c < r8; ++c) {
    const uint32_t uo = 2 * c * ulbo, vo = 2 * c * vlbo;
    wgmma_m64n32k8_tf32(sacc, tf32_desc(ul + uo, ulbo), tf32_desc(vh + vo, vlbo), c > 0);
    wgmma_m64n32k8_tf32(sacc, tf32_desc(uh + uo, ulbo), tf32_desc(vl + vo, vlbo), 1);
    wgmma_m64n32k8_tf32(sacc, tf32_desc(uh + uo, ulbo), tf32_desc(vh + vo, vlbo), 1);
  }
  wgmma_commit();
}

// mbarriers in shared memory (tracking TMA completion by bytes)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 2-D box of a tensor map into shared memory, completing bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// A tensor map of a row-major bf16 matrix (rows x cols) read in boxes of
// box_rows x 64 columns (128 bytes, the 128-byte swizzle); rows past the
// end read as zeros.  False if the driver refuses it.
inline bool bf16_tile_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        fn == nullptr)
      return false;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// f32 scratch of the pre-pass, in floats: split A and B, or S
inline size_t prepass_floats(bool s_mem, int r8, int N, int K) {
  return s_mem ? (size_t)N * K : (size_t)2 * 8 * r8 * ((size_t)K + N);
}

// blocks of a grid-stride loop over n items, 256 threads each
inline int grid_for(size_t n) { return (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024); }

// The pre-pass, once per call.  In-kernel mode: the 3xTF32 split of A and
// B, rank padded to 8·r8 with zeros: A_hi / A_lo as one A_ROWS-column x
// 8·r8 tile per A_ROWS columns of K, B_hi / B_lo as one B_ROWS-row x 8·r8
// tile per B_ROWS rows of N.  A tile of `rows` rows is K-major in the
// core-matrix order of `tf32_desc`: element (row, rank) at float
// ((rank/4)·(rows/8) + row/8)·32 + (row%8)·4 + rank%4, so rank groups of 4
// lie rows·16 bytes apart.  Memory mode: S = B·A, (N, K) f32.
template <int A_ROWS, int B_ROWS>
__global__ void prepass_kernel(const float* __restrict__ b, const float* __restrict__ a,
                               float* __restrict__ ws, int N, int K, int r, int r8,
                               int s_mem) {
  const int rp = 8 * r8;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s_mem) {
    for (size_t i = i0; i < (size_t)N * K; i += stride) {
      const size_t n = i / K, k = i % K;
      float s = 0.f;
      for (int rr = 0; rr < r; ++rr) s = fmaf(b[n * r + rr], a[(size_t)rr * K + k], s);
      ws[i] = s;
    }
    return;
  }
  const size_t na = (size_t)rp * K, nb = (size_t)N * rp;
  float *a_hi = ws, *a_lo = ws + na, *b_hi = a_lo + na, *b_lo = b_hi + nb;
  for (size_t i = i0; i < na + nb; i += stride) {
    const bool is_a = i < na;
    const size_t j = is_a ? i : i - na;
    const int rows = is_a ? A_ROWS : B_ROWS;
    const size_t tile = j / ((size_t)rows * rp);
    const int o = (int)(j % ((size_t)rows * rp));
    const int rank = (o / (4 * rows)) * 4 + (o & 3);
    const int row = ((o % (4 * rows)) >> 5) * 8 + ((o >> 2) & 7);
    float v = 0.f;
    if (rank < r)
      v = is_a ? a[(size_t)rank * K + tile * A_ROWS + row] : b[(tile * B_ROWS + row) * r + rank];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    (is_a ? a_hi : b_hi)[j] = __uint_as_float(hi);
    (is_a ? a_lo : b_lo)[j] = __uint_as_float(lo);
  }
}

// Run the pre-pass on `stream`; returns the CUDA error of the launch.
template <int A_ROWS, int B_ROWS>
inline cudaError_t prepass(const void* b, const void* a, float* ws, int N, int K, int r, int r8,
                           bool s_mem, cudaStream_t stream) {
  const size_t items = s_mem ? (size_t)N * K : prepass_floats(false, r8, N, K) / 2;
  prepass_kernel<A_ROWS, B_ROWS><<<grid_for(items), 256, 0, stream>>>(
      static_cast<const float*>(b), static_cast<const float*>(a), ws, N, K, r, r8, s_mem);
  return cudaGetLastError();
}

}  // namespace hopper
