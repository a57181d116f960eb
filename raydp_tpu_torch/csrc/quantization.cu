// Int8 quantization kernels for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// quantize_stochastic_rows_kernel and quantize_stochastic_kernel replace, in
// raydp_tpu/ops/quantization.py, _quant_kernel, launched by the pallas_call
// of _quantize_pallas (K5):
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
// What bounds it on an H100: bytes, 4 read and 1 written per element (at
// [16384, 4096] 0.100 ms at 3.35 TB/s). Philox's ten rounds (two 32x32 ->
// 64-bit multiplies and two three-way xors each) per 4 elements and the
// division per element come near the bytes' time in issue slots, so they
// have to run while loads are in flight. Design:
// - The register body (quantize_stochastic_rows_kernel) reads each element
//   from memory once: a row lives in registers between its absmax and its
//   rounding. Up to D 1024 a warp takes a row (8 x 16 bytes a lane, 8 rows
//   a block, reduced by shuffles alone); up to D 4096 a block of 256 takes
//   it (4 x 16 bytes a thread, shuffles and one exchange through shared
//   memory). A thread issues its loads, then draws its Philox blocks while
//   they are in flight; the rounds' keys are computed once a thread. (A
//   persistent grid that loads the next row before rounding the current
//   one, into registers or through a cp.async ring in shared memory, was
//   measured slower on the H100.)
// - The general body (quantize_stochastic_kernel), for D % 4 != 0, an
//   unaligned x or D > 4096: one block per row; pass 1 takes the absmax,
//   pass 2 reads the row again and writes the values, single elements (a
//   group of 4 then may straddle two rows).
// A max is exact in any order, so the scale equals torch.amax's.
//
// quantize_rows_kernel is its deterministic twin, the counterpart of the
// JAX package's quantize_int8(stochastic=False) (jnp code in
// raydp_tpu/ops/quantization.py, not a Pallas kernel): per row
//   s = max(absmax(x) / 127, 1e-12),  values = clip(rint(x / s), +-127)
// with IEEE division and rint's half to even, as torch.round and jnp.round
// round. It reads f32 or bf16 (bf16 -> f32 is exact, so no cast launch),
// takes up to two segments of rows with one D (the int8 product quantizes
// its activations and its weights in one launch) and writes the values
// into rows of `ld` bytes, zero past D (ld = round_up(D, 16) gives the
// product's TMA the 16-byte row pitch it needs). Bound: bytes, as K5. One
// block per row: pass 1 the absmax, pass 2 the values, 8 elements a thread
// (16- or 32-byte loads, 8-byte stores) where the row allows it.
//
// int8_gemm_sm90_kernel is the int8 product of ops/quantization.py:int8_matmul;
// in the JAX package it is jax.lax.dot_general int8 x int8 -> int32, not a
// Pallas kernel. xq [N, K] int8, wq [M, K] int8 (both K-contiguous, rows
// `pitch` bytes apart, pitch a multiple of 16 with zeros past K), xs [N] and
// ws [M] f32 ->
//   out[n, m] = cast((float(sum_k xq[n,k] * wq[m,k]) * xs[n]) * ws[m])
// in f32 or bf16 (round to nearest even). The sum is exact int32, so any
// order of it gives the same bits; the conversion __int2float_rn and the two
// multiplies are IEEE in that order, so the result equals
// ops/quantization.py's plain version bit for bit.
//
// What bounds it on an H100: operations at the training step's shapes (N
// 16384, K 1024 / M 4096 and K 4096 / M 1024: 1.37e11 operations, 0.069 ms
// at the 1979 TOP/s dense int8 peak, against 0.031-0.046 ms of bytes), bytes
// at decode's N 4 (the 4 MB of weights, 0.0013 ms). The design:
// - wgmma m64nNk32 s8 -> s32 on the tensor cores (the only route to
//   Hopper's int8 rate), both operands K-major, which is the only layout
//   wgmma takes for 8-bit types and the one xq and wq already have.
// - K in tiles of 128 bytes through TMA (2-D maps, the 128-byte swizzle)
//   into a four-stage mbarrier ring; one producer thread issues every load,
//   consumer warpgroups issue the products and keep one group in flight,
//   releasing a stage when the group that read it has finished. Rows past N
//   or M and bytes past the pitch read as zeros, which leave the sums as
//   they are; the epilogue bounds-checks every element.
// - Large N (training, prefill): A = xq, B = wq, 128 x 256 output tiles,
//   two consumer warpgroups of 64 rows (m64n256k32, 128 accumulators a
//   thread; setmaxnreg 24 / 240 as the attention kernels). The blocks are
//   persistent, one per SM, each walking the tiles blockIdx.x, + gridDim.x,
//   ...: the producer runs on into the next tile's K-tiles while the
//   consumers write the last one, so the ring's fill and the epilogue
//   overlap. With bf16 out (the model's case) each warpgroup writes its
//   64 x 256 tile into shared memory, swizzled as the TMA reads it (free
//   of bank conflicts), and one thread hands it to four TMA stores, which
//   drain while the warpgroup runs the next tile's products; the ring then
//   has three stages (3 x 48 KB + 64 KB of output). f32 out, and bf16 out
//   whose rows TMA cannot address (M % 8 != 0), write pairs of
//   neighbouring columns from registers, with a four-stage ring.
// - Small N (N <= 16, decode): the operands swap, so that the weights fill
//   wgmma's 64-row side: A = wq in 64-row tiles, B = xq as the n side (n 16,
//   rows past N zeros), and the accumulator holds out^T. K is split over
//   gridDim.y so that a few hundred blocks stream the weights. Each split
//   stores its int32 partial tile; the last block of a tile to arrive (an
//   atomic ticket per tile, which that block resets to 0 for the next
//   launch) sums the partials and runs the epilogue. Integer sums in any
//   order give the same bits, so the result does not depend on which
//   block arrives last. The epilogue still multiplies by xs[n] first and
//   ws[m] second.

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90_common.cuh"

namespace {

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// K5: stochastic rounding
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
constexpr int kPhiloxRounds = 10;

// The key of each of Philox's ten rounds, (k0, k1) bumped by the Weyl
// increments: computed once a thread, not once a block of 4 words.
struct PhiloxKeys {
  uint32_t k0[kPhiloxRounds], k1[kPhiloxRounds];

  __device__ __forceinline__ PhiloxKeys(uint32_t a, uint32_t b) {
#pragma unroll
    for (int r = 0; r < kPhiloxRounds; ++r) {
      k0[r] = a + r * kPhiloxW0;
      k1[r] = b + r * kPhiloxW1;
    }
  }
};

// Philox4x32-10 of the counter (lo32(block), hi32(block), 0, 0).
__device__ __forceinline__ uint4 philox_block(uint64_t block,
                                              const PhiloxKeys& keys) {
  uint4 c = make_uint4(static_cast<uint32_t>(block),
                       static_cast<uint32_t>(block >> 32), 0u, 0u);
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ keys.k0[r], lo1, hi0 ^ c.w ^ keys.k1[r], lo0);
  }
  return c;
}

__device__ __forceinline__ int8_t round_stochastic(float x, float scale,
                                                   uint32_t bits) {
  const float u = __fmul_rn(static_cast<float>(bits >> 9), 0x1p-23f);
  const float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

// The row's absmax over every thread of the block (exact in any order),
// then the scale max(absmax / 127, 1e-12) with IEEE division.
template <int kThreads>
__device__ __forceinline__ float block_scale(float amax, float* warp_maxes) {
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) warp_maxes[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_maxes[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_maxes[w]);
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

// The register body: kLanes threads take a row (a warp, kQuantThreads / 32
// rows a block; or the whole block, one row), kVec groups of 4 elements a
// thread, so each element is read from memory once and stays in registers
// between its row's absmax and its rounding. Group g of a row (16 bytes of
// x, 4 of values) belongs to thread g % kLanes: a warp's loads and stores
// are contiguous. A thread issues all its loads first and draws its Philox
// blocks (the counter depends only on the element's index) while they are
// in flight. Rows need d % 4 == 0, d <= 4 * kLanes * kVec and a 16-byte
// aligned x.
template <int kLanes, int kVec>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_stochastic_rows_kernel(const float* __restrict__ x,
                                    int8_t* __restrict__ values,
                                    float* __restrict__ scales, int n, int d,
                                    uint32_t k0, uint32_t k1) {
  static_assert(kLanes == 32 || kLanes == kQuantThreads, "a warp or a block");
  constexpr int kRows = kQuantThreads / kLanes;
  __shared__ float warp_maxes[kQuantThreads / 32];
  const int lane = threadIdx.x % kLanes;
  const size_t row =
      static_cast<size_t>(blockIdx.x) * kRows + threadIdx.x / kLanes;
  if (kRows > 1 && row >= static_cast<size_t>(n)) return;  // a whole warp
  const int groups = d >> 2;
  const size_t e0 = row * static_cast<size_t>(d);
  const float4* x4 = reinterpret_cast<const float4*>(x + e0);

  float4 xv[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int g = lane + v * kLanes;
    xv[v] = g < groups ? __ldcs(x4 + g) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const PhiloxKeys keys(k0, k1);
  const uint64_t block0 = e0 >> 2;
  uint4 bits[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int g = lane + v * kLanes;
    if (g < groups) bits[v] = philox_block(block0 + g, keys);
  }

  float amax = 0.f;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(xv[v].x), fabsf(xv[v].y)),
                             fmaxf(fabsf(xv[v].z), fabsf(xv[v].w))));
  }
  float scale;
  if constexpr (kRows > 1) {
    scale = fmaxf(__fdiv_rn(warp_max(amax), 127.f), 1e-12f);
  } else {
    scale = block_scale<kQuantThreads>(amax, warp_maxes);
  }
  if (lane == 0) scales[row] = scale;

  char4* v4 = reinterpret_cast<char4*>(values + e0);
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int g = lane + v * kLanes;
    if (g < groups) {
      v4[g] = make_char4(round_stochastic(xv[v].x, scale, bits[v].x),
                         round_stochastic(xv[v].y, scale, bits[v].y),
                         round_stochastic(xv[v].z, scale, bits[v].z),
                         round_stochastic(xv[v].w, scale, bits[v].w));
    }
  }
}

// The register bodies' reach: a warp a row up to 1024 elements, a block a
// row up to 4096.
constexpr int kWarpRowVec = 8, kBlockRowVec = 4;
constexpr int kWarpRowMax = 4 * 32 * kWarpRowVec;
constexpr int kBlockRowMax = 4 * kQuantThreads * kBlockRowVec;

// The general body, for rows the register bodies do not take (d % 4 != 0,
// an unaligned x, d > kBlockRowMax): one block a row, pass 1 the absmax,
// pass 2 reads the row again and writes the values, one Philox block a
// thread per group of 4 elements (a group then may straddle two rows).
__global__ void __launch_bounds__(kQuantThreads)
    quantize_stochastic_kernel(const float* __restrict__ x,
                               int8_t* __restrict__ values,
                               float* __restrict__ scales, int d, uint32_t k0,
                               uint32_t k1) {
  __shared__ float warp_maxes[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const size_t e0 = row * static_cast<size_t>(d);
  const float* xr = x + e0;

  float amax = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) amax = fmaxf(amax, fabsf(xr[c]));
  const float scale = block_scale<kQuantThreads>(amax, warp_maxes);
  if (threadIdx.x == 0) scales[row] = scale;

  const PhiloxKeys keys(k0, k1);
  const uint64_t e1 = e0 + d;
  const uint64_t g0 = e0 >> 2, g1 = (e1 + 3) >> 2;
  for (uint64_t g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const uint4 r = philox_block(g, keys);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint64_t e = 4 * g + w;
      if (e >= e0 && e < e1) values[e] = round_stochastic(x[e], scale, bits[w]);
    }
  }
}

// A register body's launch: a block for each kQuantThreads / kLanes rows.
template <int kLanes, int kVec>
int launch_stochastic_rows(const float* x, int8_t* values, float* scales, int n,
                           int d, uint32_t k0, uint32_t k1, cudaStream_t s) {
  constexpr int kRows = kQuantThreads / kLanes;
  quantize_stochastic_rows_kernel<kLanes, kVec>
      <<<(n + kRows - 1) / kRows, kQuantThreads, 0, s>>>(x, values, scales, n,
                                                         d, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// deterministic rounding: quantize_rows_kernel
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 128;

__device__ __forceinline__ int8_t round_nearest(float x, float scale) {
  const float v = rintf(__fdiv_rn(x, scale));  // half to even
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

// 8 consecutive elements as f32 from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// One row: d elements of xr -> scale, and ld bytes of values (zeros past d).
// vec: d % 8 == 0, xr 16-byte aligned, vr 8-byte aligned.
template <typename T>
__device__ __forceinline__ void quantize_row(const T* __restrict__ xr, int d,
                                             bool vec, int8_t* __restrict__ vr,
                                             int ld, float* __restrict__ scale_out,
                                             float* warp_maxes) {
  float amax = 0.f;
  if (vec) {
    for (int g = threadIdx.x; g < d / 8; g += kRowThreads) {
      float x[8];
      load8(xr + 8 * g, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kRowThreads) {
      amax = fmaxf(amax, fabsf(to_f32(xr[c])));
    }
  }
  const float scale = block_scale<kRowThreads>(amax, warp_maxes);
  if (threadIdx.x == 0) *scale_out = scale;

  if (vec) {
    for (int g = threadIdx.x; g < d / 8; g += kRowThreads) {
      float x[8];
      load8(xr + 8 * g, x);
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h] = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint8_t b = static_cast<uint8_t>(round_nearest(x[4 * h + i], scale));
          w[h] |= static_cast<uint32_t>(b) << (8 * i);
        }
      }
      reinterpret_cast<uint2*>(vr)[g] = make_uint2(w[0], w[1]);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kRowThreads) {
      vr[c] = round_nearest(to_f32(xr[c]), scale);
    }
  }
  for (int c = d + threadIdx.x; c < ld; c += kRowThreads) vr[c] = 0;
}

// Rows [0, rows0) of x0, then rows [0, rows1) of x1, each of d elements of
// type dtype0 / dtype1 (kF32 or kBF16): block b quantizes row b of that
// sequence into values[b * ld ...] and scales[b].
__global__ void __launch_bounds__(kRowThreads)
    quantize_rows_kernel(const void* __restrict__ x0, int rows0, int dtype0,
                         const void* __restrict__ x1, int dtype1,
                         int8_t* __restrict__ values,
                         float* __restrict__ scales, int d, int ld,
                         bool vec_out) {
  __shared__ float warp_maxes[kRowThreads / 32];
  const int row = blockIdx.x;
  const bool second = row >= rows0;
  const void* base = second ? x1 : x0;
  const size_t r = second ? row - rows0 : row;
  const int dtype = second ? dtype1 : dtype0;
  int8_t* vr = values + static_cast<size_t>(row) * ld;
  const bool vec = vec_out && d % 8 == 0;
  if (dtype == kF32) {
    const float* xr = static_cast<const float*>(base) + r * d;
    quantize_row(xr, d, vec && aligned16(xr), vr, ld, scales + row, warp_maxes);
  } else {
    const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(base) + r * d;
    quantize_row(xr, d, vec && aligned16(xr), vr, ld, scales + row, warp_maxes);
  }
}

// ---------------------------------------------------------------------------
// int8 GEMM on wgmma s8
// ---------------------------------------------------------------------------

constexpr int kKTile = 128;        // bytes of K per ring stage (one swizzle row)
constexpr int kSmallN = 16;        // N up to this takes the swapped mode
constexpr int kSplitBlocks = 264;  // swapped mode: aim for 2 blocks per SM

// kSwap false: A = xq (N side), 2 consumer warpgroups x 64 rows, B = wq
// (M side), 256 rows; with kStaged (bf16 out) the output tile goes out
// through shared memory and TMA stores. kSwap true: A = wq (M side), 1
// warpgroup x 64 rows, B = xq (N side), 16 rows.
template <bool kSwap, bool kStaged>
struct GemmCfg {
  static constexpr int kStages = kStaged ? 3 : 4;
  static constexpr int kConsumers = kSwap ? 1 : 2;
  static constexpr int kARows = 64 * kConsumers;
  static constexpr int kBRows = kSwap ? kSmallN : 256;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kAcc = kBRows / 2;  // s32 accumulators a thread
  static constexpr int kAStage = kARows * kKTile;
  static constexpr int kBStage = kBRows * kKTile;
  static constexpr int kOutBox = 64 * 128;  // 64 rows x 64 bf16 columns
  static constexpr int kOutWg = kStaged ? (kBRows / 64) * kOutBox : 0;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kStages * kAStage;
  static constexpr int kOut = kB + kStages * kBStage;
  static constexpr int kBar = kOut + kConsumers * kOutWg;  // full[], empty[]
  static constexpr int kBytes = kBar + 16 * kStages + 1024;
  static constexpr int kPartial = 64 * kBRows;  // s32 of a split's tile
};

// Barrier `id` over one warpgroup's 128 threads.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (N == 256) {
    wgmma_s8_n256(d, a, b);
  } else {
    wgmma_s8_n16(d, a, b);
  }
}

__device__ __forceinline__ float scaled(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

template <typename T>
__device__ __forceinline__ void store_scaled(T* out, int n, int m, int rows,
                                             int cols, int acc,
                                             const float* xs, const float* ws) {
  if (n < rows && m < cols) {
    out[static_cast<size_t>(n) * cols + m] = from_f32<T>(scaled(acc, xs[n], ws[m]));
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Columns m and m + 1 (m even) of row n; one 2-element store where both
// exist and the row length keeps the pair aligned.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int n, int m, int rows,
                                           int cols, int a0, int a1,
                                           const float* xs, const float* ws) {
  if (n >= rows) return;
  if (m + 1 < cols && (cols & 1) == 0) {
    const float x = xs[n];
    store2(out + static_cast<size_t>(n) * cols + m, scaled(a0, x, ws[m]),
           scaled(a1, x, ws[m + 1]));
  } else {
    store_scaled(out, n, m, rows, cols, a0, xs, ws);
    store_scaled(out, n, m + 1, rows, cols, a1, xs, ws);
  }
}

// tm_a / tm_b: the A and B maps (boxes of kARows and kBRows rows). n, m: the
// output's rows and columns. k_tiles: 128-byte K-tiles in all; each split
// (blockIdx.y, swapped mode) takes tiles_per_split of them. partial: the
// splits' s32 tiles [gridDim.y][gridDim.x][kPartial]; tickets: one counter
// per tile, 0 before the launch and after it. The large mode's output tiles
// (tile_m fastest) are shared out over the persistent blocks; the swapped
// mode's block owns tile blockIdx.x.
template <bool kSwap, typename T, bool kStaged>
__global__ void __launch_bounds__(GemmCfg<kSwap, kStaged>::kThreads, 1)
int8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_out,
                      const float* __restrict__ xs, const float* __restrict__ ws,
                      T* __restrict__ out, int* __restrict__ partial,
                      int* __restrict__ tickets, int n, int m, int k_tiles,
                      int tiles_per_split) {
  using C = GemmCfg<kSwap, kStaged>;
  static_assert(!kStaged || (!kSwap && std::is_same<T, __nv_bfloat16>::value),
                "the staged epilogue writes bf16 tiles of the large mode");
  constexpr int kGemmStages = C::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int ticket;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_a = base + C::kA;
  const uint32_t s_b = base + C::kB;
  const uint32_t s_out = base + C::kOut;                     // + wg * kOutWg
  const uint32_t bar_full = base + C::kBar;                  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kGemmStages;     // + 8 * stage

  // the block's output tiles and each tile's K-tiles
  const int m_tiles = (m + C::kBRows - 1) / C::kBRows;
  const int n_tiles = kSwap ? 1 : m_tiles * ((n + C::kARows - 1) / C::kARows);
  const int tile0 = kSwap ? blockIdx.y * tiles_per_split : 0;
  const int n_it = (kSwap ? min(k_tiles, tile0 + tiles_per_split) : k_tiles) - tile0;
  const int first = kSwap ? 0 : blockIdx.x;
  const int step = kSwap ? 1 : gridDim.x;
  auto rows_of = [&](int tile, int& a_row0, int& b_row0) {
    if (kSwap) {
      a_row0 = blockIdx.x * C::kARows;
      b_row0 = 0;
    } else {
      a_row0 = (tile / m_tiles) * C::kARows;
      b_row0 = (tile % m_tiles) * C::kBRows;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, C::kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {
    // producer: one thread issues every TMA load, running ahead across tiles
    if constexpr (!kSwap) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    }
    if (threadIdx.x == C::kConsumers * 128) {
      int g = 0;  // ring slot count over all of the block's K-tiles
      for (int tile = first; tile < n_tiles; tile += step) {
        int a_row0, b_row0;
        rows_of(tile, a_row0, b_row0);
        for (int it = 0; it < n_it; ++it, ++g) {
          const int s = g % kGemmStages;
          mbar_wait(bar_empty + 8 * s, ((g / kGemmStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, C::kAStage + C::kBStage);
          const int col = (tile0 + it) * kKTile;
          tma_load_2d(s_a + s * C::kAStage, &tm_a, bar_full + 8 * s, col, a_row0);
          tma_load_2d(s_b + s * C::kBStage, &tm_b, bar_full + 8 * s, col, b_row0);
        }
      }
    }
    return;
  }
  if constexpr (!kSwap) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  }
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int g = 0;
  for (int tile = first; tile < n_tiles; tile += step) {
    int a_row0, b_row0;
    rows_of(tile, a_row0, b_row0);
    uint32_t acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0;

    for (int it = 0; it < n_it; ++it, ++g) {
      const int s = g % kGemmStages;
      mbar_wait(bar_full + 8 * s, (g / kGemmStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKTile / 32; ++kk) {
        wgmma_s8<C::kBRows>(
            acc, sw128_desc(s_a + s * C::kAStage + wg * 64 * kKTile + kk * 32, 16, 1024),
            sw128_desc(s_b + s * C::kBStage + kk * 32, 16, 1024));
      }
      wgmma_commit();
      if (it > 0) {  // the group of the previous K-tile has read its stage
        wgmma_wait_one();
        fence_regs(acc);
        mbar_arrive(bar_empty + 8 * ((g - 1) % kGemmStages));
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * ((g - 1) % kGemmStages));

    // accumulator i of this thread: row r(i) of the warpgroup's 64, column
    // c(i) of the B tile's kBRows
    if constexpr (kSwap) {
      if (gridDim.y > 1) {
        int* mine = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                                  C::kPartial;
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) {
          const int r = 16 * warp + lane / 4 + 8 * half_of(i);
          mine[r * C::kBRows + col_of(i, lane)] = static_cast<int>(acc[i]);
        }
        __threadfence();
        asm volatile("bar.sync 1, 128;" ::: "memory");
        if (tid == 0) ticket = atomicAdd(tickets + blockIdx.x, 1);
        asm volatile("bar.sync 1, 128;" ::: "memory");
        if (ticket != static_cast<int>(gridDim.y) - 1) return;
        __threadfence();  // every split's tile is visible: sum them
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) {
          const int r = 16 * warp + lane / 4 + 8 * half_of(i);
          int sum = 0;
          for (int sp = 0; sp < static_cast<int>(gridDim.y); ++sp) {
            sum += __ldcg(partial + (static_cast<size_t>(sp) * gridDim.x + blockIdx.x) *
                                        C::kPartial +
                          r * C::kBRows + col_of(i, lane));
          }
          acc[i] = static_cast<uint32_t>(sum);
        }
        if (tid == 0) tickets[blockIdx.x] = 0;  // ready for the next launch
      }
      // out^T: row r is output column m, column c output row n
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) {
        const int r = 16 * warp + lane / 4 + 8 * half_of(i);
        store_scaled(out, col_of(i, lane), a_row0 + r, n, m,
                     static_cast<int>(acc[i]), xs, ws);
      }
    } else if constexpr (kStaged) {
      // the warpgroup's last stores have read the staging tile
      if (tid == 0) tma_store_wait_read();
      named_sync(2 + wg);
      const uint32_t mine = s_out + wg * C::kOutWg;
      float x[2];  // the scales of this thread's two rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = a_row0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
        x[h] = row < n ? xs[row] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < C::kBRows / 8; ++j) {  // 8-column blocks
        const int c = 8 * j + 2 * (lane & 3);
        const int col = b_row0 + c;
        const float w0 = col < m ? ws[col] : 0.f;
        const float w1 = col + 1 < m ? ws[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + lane / 4 + 8 * h;  // row in the warpgroup
          const int i = 4 * j + 2 * h;  // col_of(i) == c, half_of(i) == h
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              scaled(static_cast<int>(acc[i]), x[h], w0),
              scaled(static_cast<int>(acc[i + 1]), x[h], w1));
          // box c / 64, 16-byte chunk (c % 64) / 8 swizzled by the row
          const uint32_t at = mine + (c / 64) * C::kOutBox + r * 128 +
                              ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      fence_proxy_async();
      named_sync(2 + wg);
      if (tid == 0) {
#pragma unroll
        for (int box = 0; box < C::kBRows / 64; ++box) {
          tma_store_2d(&tm_out, mine + box * C::kOutBox, b_row0 + 64 * box,
                       a_row0 + 64 * wg);
        }
        tma_store_commit();
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::kAcc; i += 2) {
        const int r = a_row0 + 64 * wg + 16 * warp + lane / 4 + 8 * half_of(i);
        store_pair(out, r, b_row0 + col_of(i, lane), n, m,
                   static_cast<int>(acc[i]), static_cast<int>(acc[i + 1]), xs, ws);
      }
    }
  }
  if constexpr (kStaged) {
    if (tid == 0) tma_store_wait();  // the last tile is written
  }
}

// The card's SMs: the large mode's persistent blocks, one each.
int sm_count() {
  static const int count = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return count;
}

// Splits of K in the swapped mode: enough blocks to stream the weights from
// every SM, no split empty. 1 in the large mode.
int gemm_splits(int n, int m, int pitch) {
  if (n > kSmallN) return 1;
  const int k_tiles = (pitch + kKTile - 1) / kKTile;
  const int m_tiles = (m + 63) / 64;
  const int want = std::max(1, std::min(k_tiles, (kSplitBlocks + m_tiles - 1) / m_tiles));
  const int per = (k_tiles + want - 1) / want;
  return (k_tiles + per - 1) / per;
}

template <bool kSwap, typename T, bool kStaged>
int launch_gemm(const void* xq, const float* xs, const void* wq,
                const float* ws, void* out, int* partial, int* tickets, int n,
                int m, int pitch, cudaStream_t stream) {
  using C = GemmCfg<kSwap, kStaged>;
  const int k_tiles = (pitch + kKTile - 1) / kKTile;
  CUtensorMap map_a, map_b, map_out{};
  const void* a = kSwap ? wq : xq;
  const void* b = kSwap ? xq : wq;
  const int a_rows = kSwap ? m : n, b_rows = kSwap ? n : m;
  if (!make_map_s8(&map_a, a, a_rows, pitch, pitch, C::kARows) ||
      !make_map_s8(&map_b, b, b_rows, pitch, pitch, C::kBRows) ||
      (kStaged && !make_map_bf16_2d(&map_out, out, n, m, 64))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = int8_gemm_sm90_kernel<kSwap, T, kStaged>;
  cudaError_t err = prepare(kernel, C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int splits = 1, per = k_tiles;
  dim3 grid;
  if (kSwap) {
    splits = gemm_splits(n, m, pitch);
    per = (k_tiles + splits - 1) / splits;
    grid = dim3((m + C::kARows - 1) / C::kARows, splits);
  } else {
    const long tiles = static_cast<long>((m + C::kBRows - 1) / C::kBRows) *
                       ((n + C::kARows - 1) / C::kARows);
    if (tiles > (1L << 30)) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(std::min<long>(tiles, sm_count())));
  }
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      map_a, map_b, map_out, xs, ws, static_cast<T*>(out), partial, tickets, n,
      m, k_tiles, per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_int8_gemm(const void* xq, const float* xs, const void* wq,
                     const float* ws, void* out, int* partial, int* tickets,
                     int n, int m, int pitch, cudaStream_t stream) {
  if (n <= kSmallN) {
    return launch_gemm<true, T, false>(xq, xs, wq, ws, out, partial, tickets,
                                       n, m, pitch, stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (m % 8 == 0 && aligned16(out)) {  // rows TMA can address
      return launch_gemm<false, T, true>(xq, xs, wq, ws, out, partial, tickets,
                                         n, m, pitch, stream);
    }
  }
  return launch_gemm<false, T, false>(xq, xs, wq, ws, out, partial, tickets, n,
                                      m, pitch, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); a bad shape
// returns cudaErrorInvalidValue without launching.
int rtt_quantize_stochastic(const void* x, void* values, void* scales, int n,
                            int d, uint32_t k0, uint32_t k1, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int8_t* vals = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  const bool vec = d % 4 == 0 && aligned16(x);
  if (vec && d <= kWarpRowMax) {
    return launch_stochastic_rows<32, kWarpRowVec>(xf, vals, sc, n, d, k0, k1, s);
  }
  if (vec && d <= kBlockRowMax) {
    return launch_stochastic_rows<kQuantThreads, kBlockRowVec>(xf, vals, sc, n,
                                                               d, k0, k1, s);
  }
  quantize_stochastic_kernel<<<n, kQuantThreads, 0, s>>>(xf, vals, sc, d, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// rows0 rows of x0 then rows1 rows of x1 (rows1 may be 0 and x1 null), d
// elements each, dtype kF32 or kBF16 -> values [(rows0 + rows1), ld] int8
// (zeros past d; ld >= d) and scales [rows0 + rows1] f32.
int rtt_quantize_rows(const void* x0, int rows0, int dtype0, const void* x1,
                      int rows1, int dtype1, void* values, void* scales, int d,
                      int ld, void* stream) {
  const auto ok = [](int dt) { return dt == kF32 || dt == kBF16; };
  if (rows0 < 0 || rows1 < 0 || rows0 + rows1 <= 0 || d <= 0 || ld < d ||
      !ok(dtype0) || (rows1 > 0 && !ok(dtype1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_out =
      ld % 8 == 0 && (reinterpret_cast<uintptr_t>(values) & 7) == 0;
  quantize_rows_kernel<<<rows0 + rows1, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x0, rows0, dtype0, x1, dtype1, static_cast<int8_t*>(values),
      static_cast<float*>(scales), d, ld, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The K splits int8_gemm will launch for these sizes: the wrapper allocates
// splits * ceil(m / 64) * 1024 s32 of partials when it is above 1, and
// ceil(m / 64) zeroed tickets.
int rtt_int8_gemm_splits(int n, int m, int pitch) {
  return gemm_splits(n, m, pitch);
}

// out_dtype: kF32 or kBF16. xq/wq rows lie `pitch` bytes apart (pitch >= k,
// a multiple of 16, zeros past k; 16-byte aligned bases). K * 127^2 must
// stay below 2^31 (K < 133,000).
int rtt_int8_gemm(const void* xq, const void* xs, const void* wq,
                  const void* ws, void* out, void* partial, void* tickets,
                  int n, int m, int k, int pitch, int out_dtype, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || k > 133000 || pitch < k || pitch % 16 ||
      !aligned16(xq) || !aligned16(wq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  int* part = static_cast<int*>(partial);
  int* tick = static_cast<int*>(tickets);
  if (out_dtype == kF32) {
    return launch_int8_gemm<float>(xq, xsf, wq, wsf, out, part, tick, n, m,
                                   pitch, s);
  }
  if (out_dtype == kBF16) {
    return launch_int8_gemm<__nv_bfloat16>(xq, xsf, wq, wsf, out, part, tick, n,
                                           m, pitch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
