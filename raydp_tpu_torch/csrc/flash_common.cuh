// Pieces shared by the port's attention kernels (flash_attention.cu,
// flash_decode.cu, flash_forward_sm90.cu and flash_backward.cu): the k-tile
// width of the CUDA-core kernels, the masking constant, element-type
// conversions, warp reductions, the steps of the per-row k-tile update,
// the f32 bodies' 16-byte copy and float4 element, and the dynamic
// shared-memory opt-in. The dot-interaction kernel
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
// Head dims past 256 run in column chunks of kHeadChunk (the wrapper
// zero-pads D to a multiple of it: ops/flash_attention.py HEAD_CHUNK): the
// chunked bodies of every family sum each score over every chunk of D in
// one chain (the bf16 ones: a tensor-core sum per chunk, the chunks added
// in f32) and give each block one chunk of the output's columns.
constexpr int kHeadChunk = 256;
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
// keys. The split decode (flash_decode.cu) runs the score, the
// probabilities and p.v of every tile in parallel and the merges in tile
// order. Lane j holds key j of the tile; lane i holds output elements i,
// i + 32, ... (lane_elem). The f32 prefill (flash_attention.cu) spreads a
// tile over register tiles of its block, tile after tile, with the same
// rounding chain for every (row, tile): tile_prob, tile_alpha and
// merge_term themselves, and the score, sum and p.v chains written out in
// the same order. Every rounding step is an explicit _rn intrinsic (the
// compiler may not contract them), so a step gives the same bits in either
// kernel.

// The lane's score chain over D columns carried on from `s`: one
// __fmaf_rn per column, d ascending. krow(c, k) fills k[0, G) with elements
// c .. c + G - 1 of the lane's key as f32. A head dim past 256 carries the
// one chain from chunk to chunk (a chunk's sum is never started at 0 and
// added), so every D gives the chain tile_score gives.
template <int D, int G, class KRow>
__device__ __forceinline__ float score_chain(const float* qrow,
                                             const KRow& krow, float s) {
#pragma unroll 8
  for (int c = 0; c < D; c += G) {
    float k[G];
    krow(c, k);
#pragma unroll
    for (int e = 0; e < G; ++e) s = __fmaf_rn(qrow[c + e], k[e], s);
  }
  return s;
}

// The lane's score: one __fmaf_rn chain over d ascending, then the scale,
// or kNegInf where the key is masked.
template <int D, int G, class KRow>
__device__ __forceinline__ float tile_score(const float* qrow, const KRow& krow,
                                            bool live, float scale) {
  const float s = score_chain<D, G>(qrow, krow, 0.f);
  return live ? __fmul_rn(s, scale) : kNegInf;
}

// p of the lane's key against the row max m_new; exactly 0 where the score
// is masked.
__device__ __forceinline__ float tile_prob(float s, float m_new) {
  const float p = expf(__fsub_rn(s, m_new));
  return (s > kNegInf * 0.5f) ? p : 0.f;
}

// Output elements a lane holds: lane + 32 i for i < lane_elems<D>(). Below
// D 32 a lane at or past D holds element lane % D again, whose result it
// does not store (lane_owns).
template <int D>
__host__ __device__ constexpr int lane_elems() { return (D + 31) / 32; }

template <int D>
__device__ __forceinline__ int lane_elem(int lane, int i) {
  return D >= 32 ? lane + 32 * i : lane % D;
}

template <int D>
__device__ __forceinline__ bool lane_owns(int lane) {
  return D >= 32 || lane < D;
}

// pv[i] = sum over the tile's keys j, in order, of p_j * v_j[lane_elem(i)]:
// one __fmaf_rn chain per element. vat(j, e) is element e of key j's V row
// as f32.
template <int D, class VAt>
__device__ __forceinline__ void tile_pv(float p, const VAt& vat, int lane,
                                        float (&pv)[lane_elems<D>()]) {
#pragma unroll
  for (int i = 0; i < lane_elems<D>(); ++i) pv[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kBlockK; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
    for (int i = 0; i < lane_elems<D>(); ++i) {
      pv[i] = __fmaf_rn(pj, vat(j, lane_elem<D>(lane, i)), pv[i]);
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

// The f32 prefill's and the f32 backward's 16-byte copies: from global to
// shared memory, bypassing L1; !ok writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Element e of a float4 (e a constant once unrolled).
__device__ __forceinline__ float part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Above 48 KB a kernel's dynamic shared memory needs an explicit opt-in.
template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
