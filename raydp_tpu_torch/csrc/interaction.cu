// DLRM dot interaction for Hopper (sm_90a), with a plain C interface for
// ctypes: the pairwise dot products of the stacked per-feature embeddings.
//
// Replaces, in raydp_tpu/ops/interaction.py (_interaction_forward):
//   interaction_fwd  <- _interaction_kernel, launched by its pallas_call
//
// T [B, F, D] (f32 or bf16) -> out [B, F(F-1)/2] in T's type, where
//   out[b, i(i-1)/2 + j] = sum_d T[b,i,d] * T[b,j,d]   for every i > j:
// the strict lower triangle of T[b] T[b]^T packed row by row. bf16 inputs
// are widened to f32 and summed in f32; each result is rounded once.
//
// What bounds it on an H100. Each input byte is read once and each output
// written once; a pair costs 2 * D operations. At DLRM's shapes (F 7-27,
// D 16) that is under one operation per byte, so it is bound by bytes, and
// at B = 2048 those bytes take 0.3-2 us: less than a launch. So the design
// aims at the launch's floor: one round trip to memory and no block-wide
// barrier.
// - The grid is sized to the card, not to the batch: at most as many
//   blocks as the SMs hold at once, each warp walking tasks of `rows`
//   consecutive batch rows (rows ~ 64 outputs' worth, at most 32), which
//   lie contiguous in T and in out.
// - A warp stages its rows in its own slice of shared memory as f32 with
//   16-byte loads (8-byte for bf16) where D % 4 == 0 and T is aligned, up
//   to 4 a lane issued before the first store, so a task costs one round
//   trip to memory, and synchronises only itself; other rows element by
//   element. Each feature is padded with zeros to a multiple of 4 and its
//   pitch is an odd number of 16-byte units, so lanes reading different
//   features at the same d fall in different banks.
// - Lane l computes outputs l, l + 32, ... of the task, four side by side
//   (four independent chains of FMAs) from float4 reads of shared memory,
//   which makes every store coalesced. Output p of a row is the pair
//   (i, j) in entry p of a table the host builds once per F
//   (np.tril_indices order, i << 16 | j), read through the read-only
//   cache: no square root, no fix-up loop.
// - Each output is one fmaf chain over d ascending (the zero padding adds
//   exact zeros), so a launch gives the same bits every time (and the same
//   bits as the earlier one-row-a-block kernel). The Gram product runs on
//   the CUDA cores: at these shapes tensor cores would not change the
//   time.
// A row of F x stride f32 must fit one block's shared memory; a wider row is
// refused with cudaErrorInvalidValue.

#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"

namespace {

constexpr int kMaxWarps = 8;      // warps a block
constexpr int kOutsPerTask = 64;  // outputs a warp's task aims at: 2 a lane
constexpr int kMaxTaskRows = 32;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kThreadsPerSm = 2048;
constexpr int kStageBatch = 4;  // 16-byte loads a lane in flight at once
constexpr int kOutsAtOnce = 4;  // outputs a lane sums side by side

// Four consecutive elements as f32 from a 4-element aligned address.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// `vec`: d % 4 == 0 and T aligned to 4 elements, so a row is staged with
// 16-byte loads (8-byte for bf16); otherwise element by element. Either way
// a feature's d elements are followed by zeros up to a multiple of 4 in
// shared memory (`stride`, 4 * odd, is its f32 pitch), so one float4 body
// sums every D: the padding adds fmaf(0, 0, acc) == acc to each sum.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    interaction_fwd_kernel(const T* __restrict__ t, const uint32_t* __restrict__ pair_ij,
                           T* __restrict__ out, int b, int f, int d, int pairs,
                           int stride, int rows, bool vec) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* tile = reinterpret_cast<float*>(smem) + warp * rows * f * stride;
  const int tasks = (b + rows - 1) / rows;
  const int d4 = (d + 3) >> 2;  // groups of 4 a feature, padding included

  for (int task = blockIdx.x * warps + warp; task < tasks;
       task += gridDim.x * warps) {
    const int row0 = task * rows;
    const int n_rows = min(rows, b - row0);
    const T* src = t + static_cast<size_t>(row0) * f * d;
    const int groups = n_rows * f * d4;
    if (vec) {
      // every load of a batch issued before the first store to shared
      // memory: one round trip to memory for up to kStageBatch * 32 groups
      for (int g0 = lane; g0 < groups; g0 += 32 * kStageBatch) {
        float4 staged[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int g = g0 + 32 * u;
          if (g < groups) staged[u] = load4(src + 4 * g);
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int g = g0 + 32 * u;
          const int fr = g / d4;  // task row * f + feature
          if (g < groups) {
            reinterpret_cast<float4*>(tile + fr * stride)[g - fr * d4] = staged[u];
          }
        }
      }
    } else {
      const int pitch = 4 * d4;
      for (int e = lane; e < groups * 4; e += 32) {
        const int fr = e / pitch, col = e - fr * pitch;
        tile[fr * stride + col] = col < d ? to_f32(src[fr * d + col]) : 0.f;
      }
    }
    __syncwarp();

    // kOutsAtOnce outputs a lane at a time, their sums interleaved; each is
    // still one fmaf chain over d ascending
    T* dst = out + static_cast<size_t>(row0) * pairs;
    const int outs = n_rows * pairs;
    for (int o0 = lane; o0 < outs; o0 += 32 * kOutsAtOnce) {
      const float* a[kOutsAtOnce];
      const float* c[kOutsAtOnce];
#pragma unroll
      for (int u = 0; u < kOutsAtOnce; ++u) {
        const int o = min(o0 + 32 * u, outs - 1);  // past the end: a repeat
        const int r = o / pairs;
        const uint32_t ij = __ldg(pair_ij + (o - r * pairs));
        const int i = static_cast<int>(ij >> 16);
        const int j = static_cast<int>(ij & 0xffff);
        a[u] = tile + (r * f + i) * stride;
        c[u] = tile + (r * f + j) * stride;
      }
      float acc[kOutsAtOnce] = {};
      for (int k = 0; k < d; k += 4) {
#pragma unroll
        for (int u = 0; u < kOutsAtOnce; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(a[u] + k);
          const float4 y = *reinterpret_cast<const float4*>(c[u] + k);
          acc[u] = fmaf(x.x, y.x, acc[u]);
          acc[u] = fmaf(x.y, y.y, acc[u]);
          acc[u] = fmaf(x.z, y.z, acc[u]);
          acc[u] = fmaf(x.w, y.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kOutsAtOnce; ++u) {
        if (o0 + 32 * u < outs) dst[o0 + 32 * u] = from_f32<T>(acc[u]);
      }
    }
    __syncwarp();  // the next task overwrites the tile
  }
}

int sm_count() {
  static int sms = 0;  // one card type per process: only a cap on the grid
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

template <typename T>
int launch_interaction(const void* t, const uint32_t* pair_ij, void* out, int b,
                       int f, int d, cudaStream_t stream) {
  if (b <= 0 || f < 2 || d <= 0 || f > 0xffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(t) % (4 * sizeof(T)) == 0;
  const int stride = 4 * (((d + 3) / 4) | 1);
  const size_t row_bytes = static_cast<size_t>(f) * stride * sizeof(float);
  if (row_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(f) * (f - 1) / 2;
  int rows = static_cast<int>(std::min<long long>(
      kMaxTaskRows, std::max<long long>(1, kOutsPerTask / pairs)));
  rows = std::min({rows, static_cast<int>(kMaxSmem / row_bytes), b});
  const size_t task_bytes = rows * row_bytes;
  const int tasks = (b + rows - 1) / rows;
  const int warps = std::min(
      {kMaxWarps, static_cast<int>(kMaxSmem / task_bytes), tasks});
  const size_t smem = warps * task_bytes;
  const int blocks_per_sm = std::max(
      1, std::min(kThreadsPerSm / (32 * warps),
                  static_cast<int>(kMaxSmem / smem)));
  const int grid = std::min((tasks + warps - 1) / warps,
                            sm_count() * blocks_per_sm);
  auto kernel = interaction_fwd_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const T*>(t), pair_ij,
                                             static_cast<T*>(out), b, f, d,
                                             static_cast<int>(pairs), stride,
                                             rows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pair_ij: F(F-1)/2 uint32 entries (i << 16 | j) in np.tril_indices(F, -1)
// order, on T's device. Returns cudaGetLastError() after the launch (0 on
// success); an unsupported dtype or shape returns cudaErrorInvalidValue
// without launching.
int rtt_interaction_fwd(const void* t, const void* pair_ij, void* out, int b,
                        int f, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* ij = static_cast<const uint32_t*>(pair_ij);
  if (dtype == kF32) return launch_interaction<float>(t, ij, out, b, f, d, s);
  if (dtype == kBF16) {
    return launch_interaction<__nv_bfloat16>(t, ij, out, b, f, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
