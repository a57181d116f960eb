// Pieces shared by the port's attention kernels (flash_attention.cu and
// flash_backward.cu): the k-tile width, the masking constant, element-type
// conversions, warp reductions and the dynamic shared-memory opt-in.
//
// Every definition sits in an anonymous namespace, so each translation unit
// that includes this header gets its own copy and nothing clashes at link
// time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 32;        // keys (or queries) per tile: one per lane
constexpr float kNegInf = -1e30f;  // masked score; -inf would make 0*inf NaNs
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// Butterfly sum: a + b == b + a, so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// `rows` rows of D elements from row `row0` of `src` into `dst` as f32;
// rows past `rows` (up to `max_rows`) are zeros.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(const T* src, size_t row0, int rows,
                                           int max_rows, float* dst) {
  for (int i = threadIdx.x; i < max_rows * D; i += blockDim.x) {
    const int r = i / D;
    dst[i] = r < rows ? to_f32(src[(row0 + r) * D + i % D]) : 0.f;
  }
}

// Above 48 KB a kernel's dynamic shared memory needs an explicit opt-in.
template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
