// Hopper (sm_90a) building blocks of the attention kernels of
// hopper_fwd.cuh (K1, K2, K7, the K9 forward) and hopper_bwd.cuh (K3 / K4,
// K5, the K9 backward): mbarriers, TMA loads and bulk copies, the bulk f32
// reduce-add, wgmma on bf16 tiles of 64-element (128-byte) rows in the
// 128-byte swizzle, and the host-side tensor maps (cuTensorMapEncodeTiled
// through dlopen, so the libraries need no -lcuda).
//
// Tile convention: every operand tile in shared memory is a TMA box of rows
// of 64 bf16 values (128 bytes), 1 024-byte aligned, in the 128-byte swizzle:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8). One wgmma
// descriptor form (8-row groups 1 024 bytes apart) reads such a tile K-major
// (the 64 values of a row are the reduction dimension) and MN-major (the
// transpose flag; the rows are the reduction dimension, 16 rows a step:
// +2 048 bytes, +128 in the descriptor's address field).
//
// wgmma accumulators (m64nN, f32): thread t of the warpgroup (warp w = t / 32,
// lane l, g = l / 4, q4 = l % 4) holds d[4j], d[4j+1] at row 16w + g, columns
// 8j + 2q4 and + 1, and d[4j+2], d[4j+3] at row 16w + g + 8, the same
// columns, j < N / 8. A bf16 A fragment from registers for k-step kk (columns
// 16kk..16kk+15) is {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
// pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])} of such an
// accumulator.

#pragma once

#include <cuda.h>      // CUtensorMap and its enums (types only: no -lcuda)
#include <dlfcn.h>

#include "attention_common.cuh"

namespace m324 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: one box of a 4-D tensor map (D, S, H, B) into shared memory, its
// first column at `col` (0 but for the second 64-column panel of a
// 128-wide row)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head,
                                         int batch, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// bulk copy of `bytes` contiguous bytes (16-byte aligned, a multiple of 16)
// from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] for `bytes` / 4 floats, shared -> device memory, as one
// bulk operation (16-byte aligned, a multiple of 16 bytes); tracked by the
// issuing thread's bulk groups
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// all but the newest of the issuing thread's bulk operations have read
// their shared memory
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, visible to wgmma and bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (the TMA box's): 8-row groups 1 024 bytes apart (stride byte
// offset); the leading byte offset is unused for these shapes. Holds for
// K-major and MN-major operands alike.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching wgmma's registers across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D (64 x 128, f32) {+}= A (64 x 16, smem) * B (128 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) {+}= A (64 x 16, smem) * B (64 x 16, smem); kTA / kTB set
// the transpose flags (0: K-major, 1: MN-major)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
}

// D (64 x 64, f32) {+}= A (64 x 16, bf16 registers) * B (16 x 64, smem);
// kTB is B's transpose flag (1: MN-major, 0: K-major)
template <int kTB = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTB));
}

// bf16 A fragments (4 k-steps of 16 columns) of this thread's rows 16w + g
// and + 8 of a 64-row tile of 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4],
                                             const unsigned char* tile, int t) {
  const int warp = t >> 5, g = (t & 31) >> 2, q4 = t & 3;
  const unsigned char* r0 = tile + (warp * 16 + g) * 128 + 4 * q4;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = ((2 * ks + half) ^ g) << 4;
      f[ks][2 * half] = *reinterpret_cast<const uint32_t*>(r0 + off);
      f[ks][2 * half + 1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * 128 + off);
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A (cols, rows, H, B) bf16 tensor map with 128-byte swizzle and a box of
// (64, box_rows, 1, 1): a row of 128 columns is two boxes, one a 64-column
// panel; strides in elements. Returns 0 or an error code.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int h, int b,
                    long long bs, long long hs, long long rs, int box_rows,
                    int cols = kD) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 900;    // no driver entry point
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(rs) * 2,
                           static_cast<cuuint64_t>(hs) * 2,
                           static_cast<cuuint64_t>(bs) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

}  // namespace m324
