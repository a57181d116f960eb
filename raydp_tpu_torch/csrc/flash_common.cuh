// Pieces shared by the port's attention kernels (flash_attention.cu,
// flash_decode.cu, flash_forward_sm90.cu and flash_backward.cu): the k-tile
// width of the CUDA-core kernels, the masking constant, element-type
// conversions, warp reductions, the steps of the per-row k-tile update and
// the dynamic shared-memory opt-in. The dot-interaction kernel
// (interaction.cu) uses the type codes, the conversions and the opt-in.
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

// The steps of the per-row online-softmax update over one k-tile of kBlockK
// keys. The f32 prefill (row_update in flash_attention.cu) runs them in
// order, tile after tile; the split decode (flash_decode.cu) runs the score,
// the probabilities and p.v of every tile in parallel and the merges in tile
// order. Lane j holds key j of the tile; lane i holds output elements i,
// i + 32, ... Every rounding step is an explicit _rn intrinsic (the
// compiler may not contract them), so a step gives the same bits in
// either kernel.

// The lane's score: one __fmaf_rn chain over d ascending, then the scale,
// or kNegInf where the key is masked. krow(c, k) fills k[0, G) with
// elements c .. c + G - 1 of the lane's key as f32.
template <int D, int G, class KRow>
__device__ __forceinline__ float tile_score(const float* qrow, const KRow& krow,
                                            bool live, float scale) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; c += G) {
    float k[G];
    krow(c, k);
#pragma unroll
    for (int e = 0; e < G; ++e) s = __fmaf_rn(qrow[c + e], k[e], s);
  }
  return live ? __fmul_rn(s, scale) : kNegInf;
}

// p of the lane's key against the row max m_new; exactly 0 where the score
// is masked.
__device__ __forceinline__ float tile_prob(float s, float m_new) {
  const float p = expf(__fsub_rn(s, m_new));
  return (s > kNegInf * 0.5f) ? p : 0.f;
}

// pv[i] = sum over the tile's keys j, in order, of p_j * v_j[lane + 32 i]:
// one __fmaf_rn chain per element. vat(j, e) is element e of key j's V row
// as f32.
template <int D, class VAt>
__device__ __forceinline__ void tile_pv(float p, const VAt& vat, int lane,
                                        float (&pv)[D / 32]) {
#pragma unroll
  for (int i = 0; i < D / 32; ++i) pv[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kBlockK; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      pv[i] = __fmaf_rn(pj, vat(j, lane + 32 * i), pv[i]);
    }
  }
}

// The rescale of the running (l, o) where the row max moved from m to m_new.
__device__ __forceinline__ float tile_alpha(float m, float m_new) {
  return expf(__fsub_rn(m, m_new));
}

// A running sum (l, or an element of o) merged with the tile's: rescaled by
// alpha where the row max moved, else added (alpha would be exp(0) == 1,
// and the multiply is skipped as an exact identity).
__device__ __forceinline__ float merge_term(bool moved, float alpha, float run,
                                            float tile) {
  return moved ? __fmaf_rn(alpha, run, tile) : __fadd_rn(run, tile);
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
