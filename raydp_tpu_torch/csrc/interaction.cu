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
// at B = 2048 those bytes take 0.3-2 us: less than a launch.
//
// What this design does about it: it is exact and simple, not fast. There is
// no batch padding. One block of kThreads threads takes a tile of whole
// batch rows, which is contiguous in T and in out. It stages the tile's
// rows in shared memory as f32 with the row stride made odd (D | 1), so that
// two features of one row read at the same d fall in different banks. Output
// o of the tile is packed index o % P of tile row o / P: consecutive threads
// write consecutive addresses. A thread maps its packed index p to (i, j) by
// the closed form i = floor((1 + sqrt(1 + 8p)) / 2), fixed up in integers,
// and sums its D products in one fixed order, so a launch gives the same
// bits every time. A tile holds about kOutsPerBlock outputs (at least one
// row); the last tile's rows are bounds-checked. The Gram product runs on
// the CUDA cores: at these shapes tensor cores would not change the time.

#include <algorithm>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOutsPerBlock = 256;  // outputs a tile aims at: 2 per thread
constexpr size_t kStaticSmem = 48 * 1024;
// one batch row, F x (D | 1) f32, must fit the shared memory of a block;
// a larger row is refused with cudaErrorInvalidValue
constexpr size_t kMaxSmem = 227 * 1024;

// Packed index p -> (i, j), p = i(i-1)/2 + j with 0 <= j < i.
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  int r = static_cast<int>((1.f + sqrtf(8.f * static_cast<float>(p) + 1.f)) *
                           0.5f);
  while (r * (r - 1) / 2 > p) --r;  // sqrtf may round either way
  while ((r + 1) * r / 2 <= p) ++r;
  i = r;
  j = p - r * (r - 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    interaction_fwd_kernel(const T* __restrict__ t, T* __restrict__ out,
                           int b, int f, int d, int stride,
                           int rows_per_block) {
  extern __shared__ float tile[];  // [rows][f][stride]
  const int pairs = f * (f - 1) / 2;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows_per_block;
  const int rows = min(rows_per_block, b - static_cast<int>(row0));

  const T* src = t + row0 * f * d;
  const int elems = rows * f * d;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int fr = e / d;  // tile row * f + feature
    tile[fr * stride + (e - fr * d)] = to_f32(src[e]);
  }
  __syncthreads();

  T* dst = out + row0 * pairs;
  const int outs = rows * pairs;
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    const int r = o / pairs;
    int i, j;
    pair_of(o - r * pairs, i, j);
    const float* a = tile + (r * f + i) * stride;
    const float* c = tile + (r * f + j) * stride;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(a[k], c[k], acc);
    dst[o] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_interaction(const void* t, void* out, int b, int f, int d,
                       cudaStream_t stream) {
  if (b <= 0 || f < 2 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int stride = d | 1;
  const size_t row_bytes = static_cast<size_t>(f) * stride * sizeof(float);
  if (row_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = f * (f - 1) / 2;
  int rows = std::max(1, kOutsPerBlock / pairs);
  rows = std::min(rows, std::max(1, static_cast<int>(kStaticSmem / row_bytes)));
  rows = std::min(rows, b);
  const size_t smem = rows * row_bytes;
  auto kernel = interaction_fwd_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (b + rows - 1) / rows;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(t),
                                           static_cast<T*>(out), b, f, d,
                                           stride, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); an unsupported
// dtype or shape returns cudaErrorInvalidValue without launching.
int rtt_interaction_fwd(const void* t, void* out, int b, int f, int d,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_interaction<float>(t, out, b, f, d, s);
  if (dtype == kBF16) {
    return launch_interaction<__nv_bfloat16>(t, out, b, f, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
