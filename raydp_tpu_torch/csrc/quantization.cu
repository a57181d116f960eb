// Int8 quantization kernels for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// quantize_stochastic_kernel replaces, in raydp_tpu/ops/quantization.py,
//   _quant_kernel, launched by the pallas_call of _quantize_pallas (K5):
// x [N, D] f32 -> values [N, D] int8, scales [N] f32, where per row
//   s = max(absmax(x) / 127, 1e-12),  values = clip(floor(x / s + u), +-127)
// and u in [0, 1) comes from Philox4x32-10 (Random123), written out here:
// element e = row * D + col takes word e & 3 of the block at counter
// (lo32(e >> 2), hi32(e >> 2), 0, 0) under the key (lo32(seed), hi32(seed)),
// and u = (bits >> 9) * 2^-23. The TPU kernel seeds its own generator per
// row tile; this stream is one per call, independent of the launch shape,
// which is what lets ops/quantization.py's plain version reproduce it bit
// for bit. Division, the add and floor are IEEE f32 (no fast math).
//
// What bounds it on an H100: bytes. It reads 4 bytes and writes 1 per
// element; Philox is ~40 integer operations per 4 elements, far below the
// card's integer rate. At [16384, 4096] the bytes take 0.100 ms at
// 3.35 TB/s. Design: one block per row, no padding of N or D. Pass 1 takes
// the row's absmax (a max is exact in any order, so the scale equals
// torch.amax's); pass 2 reads the row again (from L1/L2: a row is at most
// a few tens of KB) and writes the values, one Philox call per thread per
// 4 consecutive elements; 16-byte loads and 4-byte stores where D % 4 == 0,
// single elements otherwise (a group of 4 then may straddle two rows).
//
// int8_gemm_kernel is the int8 product of ops/quantization.py:int8_matmul;
// in the JAX package it is jax.lax.dot_general int8 x int8 -> int32, not a
// Pallas kernel. xq [N, K] int8, wq [M, K] int8 (both K-contiguous, "TN"),
// xs [N] and ws [M] f32 ->
//   out[n, m] = cast((float(sum_k xq[n,k] * wq[m,k]) * xs[n]) * ws[m])
// in f32 or bf16 (round to nearest even). The sum is exact int32, the
// conversion __int2float_rn and the two multiplies IEEE in that order, so
// the result equals ops/quantization.py's plain version bit for bit.
//
// What bounds it on an H100: operations. At the training step's shapes
// (N 16384, K 1024 / M 4096 and K 4096 / M 1024) it does 1.37e11 operations,
// 0.069 ms at the 1979 TOP/s dense int8 peak, against 0.031-0.046 ms of
// bytes. Design, simple and right first: mma.sync.m16n8k32 s8 tensor-core
// products (not wgmma), a 128 x 128 output tile per block of 8 warps, each
// warp 64 x 32; K in steps of 64 bytes through a two-stage cp.async ring in
// shared memory (rows padded to 80 bytes, so a warp's fragment loads hit 32
// distinct banks). Rows past N or M and columns past K load as zeros (the
// sum is unchanged); where K % 16 != 0 rows are not 16-byte aligned and the
// tiles load byte by byte. The epilogue bounds-checks each element.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// K5: stochastic rounding
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint4 philox_block(uint64_t block, uint32_t k0,
                                              uint32_t k1) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(block),
                                  static_cast<uint32_t>(block >> 32), 0u, 0u),
                       k0, k1);
}

__device__ __forceinline__ int8_t round_stochastic(float x, float scale,
                                                   uint32_t bits) {
  const float u = __fmul_rn(static_cast<float>(bits >> 9), 0x1p-23f);
  const float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

__global__ void __launch_bounds__(kQuantThreads)
    quantize_stochastic_kernel(const float* __restrict__ x,
                               int8_t* __restrict__ values,
                               float* __restrict__ scales, int d, bool vec,
                               uint32_t k0, uint32_t k1) {
  __shared__ float warp_maxes[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const size_t e0 = row * static_cast<size_t>(d);
  const float* xr = x + e0;

  float amax = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) amax = fmaxf(amax, fabsf(xr[c]));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) warp_maxes[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_maxes[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_maxes[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  if (threadIdx.x == 0) scales[row] = scale;

  if (vec) {  // d % 4 == 0: groups of 4 lie inside the row, 16-byte aligned
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* v4 = reinterpret_cast<char4*>(values + e0);
    const uint64_t b0 = e0 >> 2;
    for (int g = threadIdx.x; g < (d >> 2); g += blockDim.x) {
      const uint4 r = philox_block(b0 + g, k0, k1);
      const float4 xv = x4[g];
      v4[g] = make_char4(round_stochastic(xv.x, scale, r.x),
                         round_stochastic(xv.y, scale, r.y),
                         round_stochastic(xv.z, scale, r.z),
                         round_stochastic(xv.w, scale, r.w));
    }
    return;
  }
  const uint64_t e1 = e0 + d;
  const uint64_t g0 = e0 >> 2, g1 = (e1 + 3) >> 2;
  for (uint64_t g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const uint4 r = philox_block(g, k0, k1);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint64_t e = 4 * g + w;
      if (e >= e0 && e < e1) values[e] = round_stochastic(x[e], scale, bits[w]);
    }
  }
}

// ---------------------------------------------------------------------------
// int8 GEMM
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 256;  // 8 warps: 2 along N x 4 along M
constexpr int kTileN = 128, kTileM = 128, kTileK = 64;
constexpr int kWarpN = 64, kWarpM = 32;
constexpr int kRowBytes = kTileK + 16;  // 80: conflict-free fragment loads
constexpr int kStageBytes = (kTileN + kTileM) * kRowBytes;
constexpr int kChunks = kTileK / 16;  // 16-byte chunks per tile row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [row0, row0 + kTile) x bytes [k0, k0 + kTileK) of src [rows, k] into
// tile [kTile][kRowBytes]; out-of-range bytes become zeros
template <int kTile>
__device__ __forceinline__ void load_tile(int8_t* tile, const int8_t* src,
                                          int row0, int rows, int k0, int k,
                                          bool aligned) {
  for (int c = threadIdx.x; c < kTile * kChunks; c += kGemmThreads) {
    const int r = c / kChunks;
    const int kc = k0 + (c % kChunks) * 16;
    int8_t* dst = tile + r * kRowBytes + (c % kChunks) * 16;
    const bool live = row0 + r < rows;
    const int8_t* from = src + (live ? static_cast<size_t>(row0 + r) * k : 0);
    if (aligned) {
      // k % 16 == 0 and 16-byte aligned operands: a chunk is wholly inside
      // or wholly past the row
      cp_async16(dst, live && kc < k ? from + kc : src,
                 live && kc < k ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[i] = live && kc + i < k ? from[kc + i] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t ld_word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ void store_scaled(T* out, int n, int m, int rows,
                                             int cols, int acc,
                                             const float* xs, const float* ws) {
  if (n < rows && m < cols) {
    const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs[n]), ws[m]);
    out[static_cast<size_t>(n) * cols + m] = from_f32<T>(y);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                     const int8_t* __restrict__ wq, const float* __restrict__ ws,
                     T* __restrict__ out, int n, int m, int k, bool aligned) {
  __shared__ __align__(16) int8_t smem[2 * kStageBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, quad = lane & 3;  // fragment row, column pair
  const int warp_n = (warp >> 2) * kWarpN, warp_m = (warp & 3) * kWarpM;
  const int n0 = blockIdx.y * kTileN, m0 = blockIdx.x * kTileM;
  const int k_tiles = (k + kTileK - 1) / kTileK;

  int acc[4][4][4] = {};  // [n sub-tile of 16][m sub-tile of 8][fragment]

  auto load_stage = [&](int stage, int kt) {
    int8_t* a = smem + stage * kStageBytes;
    load_tile<kTileN>(a, xq, n0, n, kt * kTileK, k, aligned);
    load_tile<kTileM>(a + kTileN * kRowBytes, wq, m0, m, kt * kTileK, k,
                      aligned);
  };

  if (k_tiles > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait_one();  // the group of tile kt has landed
    __syncthreads();
    const int8_t* a = smem + (kt & 1) * kStageBytes;
    const int8_t* b = a + kTileN * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a + (warp_n + i * 16 + group) * kRowBytes + kk + 4 * quad;
        af[i][0] = ld_word(p);
        af[i][1] = ld_word(p + 8 * kRowBytes);
        af[i][2] = ld_word(p + 16);
        af[i][3] = ld_word(p + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b + (warp_m + j * 8 + group) * kRowBytes + kk + 4 * quad;
        bf[j][0] = ld_word(p);
        bf[j][1] = ld_word(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + warp_n + i * 16 + group;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = m0 + warp_m + j * 8 + 2 * quad;
      store_scaled(out, r, c, n, m, acc[i][j][0], xs, ws);
      store_scaled(out, r, c + 1, n, m, acc[i][j][1], xs, ws);
      store_scaled(out, r + 8, c, n, m, acc[i][j][2], xs, ws);
      store_scaled(out, r + 8, c + 1, n, m, acc[i][j][3], xs, ws);
    }
  }
}

template <typename T>
int launch_int8_gemm(const void* xq, const void* xs, const void* wq,
                     const void* ws, void* out, int n, int m, int k,
                     cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = k % 16 == 0 && aligned16(xq) && aligned16(wq);
  int8_gemm_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<T*>(out), n, m, k, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); a bad shape
// returns cudaErrorInvalidValue without launching.
int rtt_quantize_stochastic(const void* x, void* values, void* scales, int n,
                            int d, uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  quantize_stochastic_kernel<<<n, kQuantThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(values),
      static_cast<float*>(scales), d, d % 4 == 0 && aligned16(x), k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// out_dtype: kF32 or kBF16. K * 127^2 must stay below 2^31 (K < 133,000).
int rtt_int8_gemm(const void* xq, const void* xs, const void* wq,
                  const void* ws, void* out, int n, int m, int k,
                  int out_dtype, void* stream) {
  if (n <= 0 || m <= 0 || k < 0 || k > 133000) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32) {
    return launch_int8_gemm<float>(xq, xs, wq, ws, out, n, m, k, s);
  }
  if (out_dtype == kBF16) {
    return launch_int8_gemm<__nv_bfloat16>(xq, xs, wq, ws, out, n, m, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
