// Hopper (sm_90a) pieces shared by the port's tensor-core kernels, the bf16
// forward (flash_forward_sm90.cu), the bf16 backward
// (flash_backward_sm90.cu) and the int8 product (quantization.cu):
// mbarriers, TMA loads and the host-side tensor maps they read, wgmma's
// shared-memory descriptors and instructions, and the register layout of a
// wgmma accumulator.
//
// Tiles live in shared memory as the TMA writes them with the 128-byte
// swizzle: a tile of R rows x D bf16 columns is D / 64 sub-tiles of R rows
// of 128 bytes, each starting on a 1024-byte boundary (the swizzle repeats
// every 1024 bytes, and the descriptors assume it). One such tile is read
// by wgmma either way:
// - K-major (the contraction runs along the row): leading byte offset 16,
//   stride byte offset 1024 (8 rows), a k16 step 32 bytes along the row,
//   the next 64 columns one sub-tile on;
// - MN-major, with the transpose bit (the contraction runs over the rows):
//   leading byte offset one sub-tile (R * 128 bytes, the next 64 output
//   columns), stride byte offset 1024, a k16 step 16 rows (2048 bytes).
// An int8 tile of R rows x 128 bytes is the same bytes: one sub-tile, read
// K-major, its k32 step 32 bytes along the row, as bf16's k16 step.
//
// Every definition sits in an anonymous namespace, as in flash_common.cuh.

#pragma once

#include <cuda.h>

#include <algorithm>

#include "flash_common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. (A watchdog on
// %globaltimer here cost the forward's consumers spills at 168 registers.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of 64 columns x (the map's box rows) x 1 head at (col, row, bh).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// One box of a 1-D map (make_rows_map) starting at element x.
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x)
      : "memory");
}

// One box of a 2-D map (make_map_s8) at byte column col, row row.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// One box of shared memory at src to a 2-D map (make_map_bf16_2d) at
// column col, row row, in the thread's current bulk group; the TMA clips
// what lies past the map's bounds. Shared-memory writes it must see need
// fence_proxy_async first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// This thread's committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// This thread's committed stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Order this thread's shared-memory writes before the TMA's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most one committed group is still running.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither moves their uses across the wait nor reuses them early.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define RTT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RTT_F16(i) RTT_F4(i), RTT_F4(i + 4), RTT_F4(i + 8), RTT_F4(i + 12)

// d[64] (+)= A[64 x 16] * B[16 x 128]: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : RTT_F16(0), RTT_F16(16), RTT_F16(32), RTT_F16(48)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with N = 64: d[32].
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_F16(0), RTT_F16(16)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with N = 32: d[16].
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : RTT_F16(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[N / 2] (+)= A[64 x 16] * B[16 x N], both from shared memory, K-major:
// N 128, 64 or 32.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    static_assert(N == 32, "wgmma_ss: N 128, 64 or 32");
    wgmma_ss_n32(d, a, b, scale_d);
  }
}

// d[128] += A[64 x 16] (registers) * B[16 x 256] (shared memory, MN-major:
// the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RTT_F16(0), RTT_F16(16), RTT_F16(32), RTT_F16(48), RTT_F16(64),
        RTT_F16(80), RTT_F16(96), RTT_F16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A[64 x 16] (registers) * B[16 x 128] (shared memory, MN-major:
// the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RTT_F16(0), RTT_F16(16), RTT_F16(32), RTT_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 64 (D 64): d[32].
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_F16(0), RTT_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RTT_F16
#undef RTT_F4

#define RTT_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define RTT_R16(i) RTT_R4(i), RTT_R4(i + 4), RTT_R4(i + 8), RTT_R4(i + 12)

// d[128] += A[64 x 32] * B[32 x 256] in s8 -> s32: A and B from shared
// memory, both K-major (the only layout wgmma takes for 8-bit types). The
// sum is exact, so the order of the k32 steps does not change it.
__device__ __forceinline__ void wgmma_s8_n256(uint32_t (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : RTT_R16(0), RTT_R16(16), RTT_R16(32), RTT_R16(48), RTT_R16(64),
        RTT_R16(80), RTT_R16(96), RTT_R16(112)
      : "l"(a), "l"(b), "r"(1));
}

// The same with N = 16: d[8].
__device__ __forceinline__ void wgmma_s8_n16(uint32_t (&d)[8], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : RTT_R4(0), RTT_R4(4)
      : "l"(a), "l"(b), "r"(1));
}

#undef RTT_R16
#undef RTT_R4

// acc[D / 2] += A[64 x 16] (registers) * B[16 x D] (shared memory,
// MN-major): the product of a rounded probability-like tile with a [rows,
// D] operand tile, D 64, 128 or 256.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 256) {
    wgmma_rs_n256(o, a, b);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, b);
  } else {
    wgmma_rs_n64(o, a, b);
  }
}

// Register i of a thread's m64nN f32 accumulator holds row
// 16 * warp + lane / 4 + 8 * half(i) and column col(i) of the 64-row tile.
__device__ __forceinline__ constexpr int half_of(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int col_of(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// An f32 accumulator as bf16 A fragments of the next product, which
// contracts over its columns: fragment k16 step kk, register j is the pair
// (x[8 kk + 2 j], x[8 kk + 2 j + 1]), low half first.
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&x)[N],
                                               uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    a[j] = *reinterpret_cast<const uint32_t*>(&pair);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that the library needs no link against libcuda (CUDA 12.5 or later).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A 3-D map [bh, rows, d] over a contiguous bf16 tensor, boxes of
// 64 x box_rows x 1 with the 128-byte swizzle; rows past `rows` read as
// zeros.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int d,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(std::max(rows, 1)),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * 2 * std::max(rows, 1)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over n contiguous f32 values, boxes of `box` values with no
// swizzle; values past n read as zeros.
bool make_rows_map(CUtensorMap* map, const float* ptr, int n, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(std::max(n, 1))};
  const cuuint64_t strides[1] = {0};  // rank 1: none is read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<float*>(ptr), dims, strides, boxes, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a row-major int8 matrix [rows, cols] whose rows lie `pitch`
// bytes apart (a multiple of 16), boxes of 128 bytes x box_rows with the
// 128-byte swizzle; rows past `rows` and bytes past `cols` read as zeros.
bool make_map_s8(CUtensorMap* map, const void* ptr, int rows, int cols,
                 int pitch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a row-major bf16 matrix [rows, cols] (cols * 2 a multiple
// of 16), boxes of 64 columns (128 bytes) x box_rows with the 128-byte
// swizzle, for TMA stores: what lies past the bounds is not written.
bool make_map_bf16_2d(CUtensorMap* map, void* ptr, int rows, int cols,
                      int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
