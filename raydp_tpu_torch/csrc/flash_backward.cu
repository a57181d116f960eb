// Flash attention backward for Hopper (sm_90a), with a plain C interface for
// ctypes: the gradient of the training path's attention, from the saved
// normalized output's row statistics (FlashAttention-2).
//
// Replaces, in raydp_tpu/ops/flash_attention.py (flash_backward_blocks):
//   flash_bwd_dq   <- _bwd_dq_kernel, launched by the pallas_call for dq
//   flash_bwd_dkv  <- _bwd_dkv_kernel, launched by the pallas_call for dk/dv
//
// Both take q/do [BH, T, D], k/v [BH, Tk, D] (f32 or bf16), the row
// logsumexp lse and dsum = rowsum(do * o) [BH, T] f32, and the blocks'
// global offsets for the causal mask. With s = scale * q.k, p = exp(s - lse)
// (exactly 0 where masked: k_pos > q_pos or past the ragged edge),
// dp = do.v and ds = p * (dp - dsum) * scale:
//   dq = sum_k ds * k,   dk = sum_q ds * q,   dv = sum_q p * do.
//
// What bounds them on an H100. For each live (query, key) pair dq recomputes
// s and dp and accumulates ds * k: 6 * D operations; dk/dv recompute s and
// dp and accumulate two products: 8 * D. At T = 8192, D = 128 that is
// thousands of operations per byte of q, k, v, do: bound by operations.
//
// What this design does about it: this first version is exact and simple,
// not fast, in the pattern of flash_attention.cu. It computes in f32 on the
// CUDA cores (no tensor cores). dq: one warp per query row, one key per lane
// over k-tiles of 32 (the forward's partition); K and V are staged
// transposed (row stride 33: lane j reading kT[d][j] and the lane that owns
// element d reading kT[d][j] are both free of bank conflicts), the row's q
// and do sit in shared memory, lse and dsum in registers, and dq[D/32] is
// accumulated in registers and written once. dk/dv: one warp per key row,
// one query per lane over q-tiles of 32; Q and dO are staged transposed with
// the tile's lse and dsum, and lane i computes p and ds for its query, which
// are shuffled across the warp into dv and dk. Causal rows skip the tiles
// wholly masked for them. The next tile's loads are in flight, in registers,
// while the current tile is computed. Splitting the work into two kernels
// (each output owned by one warp) needs no atomics, so dq, dk and dv are the
// same bits from run to run.

#include "flash_common.cuh"

namespace {

constexpr int kBwdWarps = 16;  // rows per block: query rows (dq), key rows (dk/dv)
constexpr int kStride = kBlockK + 1;  // transposed tile row stride

// One tile of kBlockK rows of two [*, D] arrays as f32, spread over the
// block's NT threads' registers.
template <int D, int NT>
struct PairTile {
  static constexpr int kPer = kBlockK * D / NT;  // elements per thread
  float a[kPer];
  float b[kPer];
};

// Rows at or past n_valid are zeros: they are masked, and zero operands keep
// every product with a masked p exact.
template <int D, int NT, typename T>
__device__ __forceinline__ void load_pair(const T* a, const T* b, size_t row0,
                                          int n_valid, PairTile<D, NT>& tile) {
#pragma unroll
  for (int u = 0; u < PairTile<D, NT>::kPer; ++u) {
    const int i = threadIdx.x + u * NT;
    const int j = i / D;
    const size_t idx = (row0 + j) * D + i % D;
    const bool ok = j < n_valid;
    tile.a[u] = ok ? to_f32(a[idx]) : 0.f;
    tile.b[u] = ok ? to_f32(b[idx]) : 0.f;
  }
}

// Both arrays transposed: aT[d][j] at d * kStride + j.
template <int D, int NT>
__device__ __forceinline__ void store_pair_t(const PairTile<D, NT>& tile,
                                             float* aT, float* bT) {
#pragma unroll
  for (int u = 0; u < PairTile<D, NT>::kPer; ++u) {
    const int i = threadIdx.x + u * NT;
    const int j = i / D;
    const int d = i % D;
    aT[d * kStride + j] = tile.a[u];
    bT[d * kStride + j] = tile.b[u];
  }
}

// x.yT[:, lane] and z.wT[:, lane] for a row x, z in shared memory (read as
// broadcasts) against one staged transposed tile.
template <int D>
__device__ __forceinline__ void two_dots(const float* x, const float* yT,
                                         const float* z, const float* wT,
                                         int lane, float& xy, float& zw) {
  xy = 0.f;
  zw = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    xy = __fmaf_rn(x[d], yT[d * kStride + lane], xy);
    zw = __fmaf_rn(z[d], wT[d * kStride + lane], zw);
  }
}

// p and ds of one (query, key) pair, exactly 0 where masked.
__device__ __forceinline__ void pair_grads(float s, float dp, float lse,
                                           float dsum, bool live, float scale,
                                           float& p, float& ds) {
  p = live ? expf(__fsub_rn(__fmul_rn(s, scale), lse)) : 0.f;
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dsum)), scale);
}

// dq: q/do [BH, T, D], k/v [BH, Tk, D], lse/dsum [BH, T] -> dq [BH, T, D] in
// q's type. grid (ceil(T / kBwdWarps), BH).
template <int D, typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, int t,
                    int tk, int q_off, int k_off, int causal, float scale) {
  extern __shared__ float smem[];
  float* kT = smem;                  // D x kStride
  float* vT = kT + D * kStride;      // D x kStride
  float* qs = vT + D * kStride;      // kBwdWarps x D
  float* dos = qs + kBwdWarps * D;   // kBwdWarps x D

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kBwdWarps;
  const int rows = min(kBwdWarps, t - row0);
  const size_t qbase = bh * t;
  const size_t kbase = bh * tk;
  stage_rows<D>(q, qbase + row0, rows, kBwdWarps, qs);
  stage_rows<D>(dout, qbase + row0, rows, kBwdWarps, dos);

  const bool has_row = warp < rows;
  const size_t row = qbase + row0 + warp;
  const int q_pos = q_off + row0 + warp;
  const float row_lse = has_row ? lse[row] : 0.f;
  const float row_dsum = has_row ? dsum[row] : 0.f;
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;

  PairTile<D, kBwdWarps * 32> tile;
  if (n_tiles > 0) load_pair(k, v, kbase, min(kBlockK, tk), tile);
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int kt0 = ti * kBlockK;
    __syncthreads();  // the previous tile is consumed; q and do are staged
    store_pair_t(tile, kT, vT);
    __syncthreads();
    if (ti + 1 < n_tiles) {  // in flight while this tile is computed
      load_pair(k, v, kbase + kt0 + kBlockK,
                min(kBlockK, tk - kt0 - kBlockK), tile);
    }
    const int k_first = k_off + kt0;
    if (has_row && (!causal || q_pos >= k_first)) {  // warp-uniform
      const bool live =
          kt0 + lane < tk && (!causal || q_pos >= k_first + lane);
      float s, dp, p, ds;
      two_dots<D>(qs + warp * D, kT, dos + warp * D, vT, lane, s, dp);
      pair_grads(s, dp, row_lse, row_dsum, live, scale, p, ds);
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          acc[i] = __fmaf_rn(dsj, kT[(lane + 32 * i) * kStride + j], acc[i]);
        }
      }
    }
  }

  if (!has_row) return;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    dq[row * D + lane + 32 * i] = from_f32<T>(acc[i]);
  }
}

// dk/dv: the same inputs -> dk, dv [BH, Tk, D] in k's type. grid
// (ceil(Tk / kBwdWarps), BH).
template <int D, typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int tk, int q_off, int k_off,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* qT = smem;                    // D x kStride
  float* doT = qT + D * kStride;       // D x kStride
  float* ks = doT + D * kStride;       // kBwdWarps x D
  float* vs = ks + kBwdWarps * D;      // kBwdWarps x D
  float* lse_s = vs + kBwdWarps * D;   // kBlockK
  float* dsum_s = lse_s + kBlockK;     // kBlockK

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int key0 = blockIdx.x * kBwdWarps;
  const int rows = min(kBwdWarps, tk - key0);
  const size_t qbase = bh * t;
  const size_t kbase = bh * tk;
  stage_rows<D>(k, kbase + key0, rows, kBwdWarps, ks);
  stage_rows<D>(v, kbase + key0, rows, kBwdWarps, vs);

  const bool has_row = warp < rows;
  const int k_pos = k_off + key0 + warp;
  const int n_qtiles = (t + kBlockK - 1) / kBlockK;
  int first = 0;  // causal: the first q-tile with a query at or after key0
  if (causal) {
    const int q_start = k_off + key0 - q_off;
    first = q_start <= 0 ? 0 : min(n_qtiles, q_start / kBlockK);
  }

  float acc_k[D / 32];
  float acc_v[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    acc_k[i] = 0.f;
    acc_v[i] = 0.f;
  }

  // the first warp carries the tile's lse and dsum, one query per lane
  const bool stats_lane = threadIdx.x < kBlockK;
  PairTile<D, kBwdWarps * 32> tile;
  float lse_r = 0.f;
  float dsum_r = 0.f;
  auto load_tile = [&](int qt0) {
    const int n = min(kBlockK, t - qt0);
    load_pair(q, dout, qbase + qt0, n, tile);
    if (stats_lane) {
      const bool ok = static_cast<int>(threadIdx.x) < n;
      lse_r = ok ? lse[qbase + qt0 + threadIdx.x] : 0.f;
      dsum_r = ok ? dsum[qbase + qt0 + threadIdx.x] : 0.f;
    }
  };
  if (first < n_qtiles) load_tile(first * kBlockK);
  for (int qi = first; qi < n_qtiles; ++qi) {
    const int qt0 = qi * kBlockK;
    __syncthreads();  // the previous tile is consumed; k and v are staged
    store_pair_t(tile, qT, doT);
    if (stats_lane) {
      lse_s[threadIdx.x] = lse_r;
      dsum_s[threadIdx.x] = dsum_r;
    }
    __syncthreads();
    if (qi + 1 < n_qtiles) load_tile(qt0 + kBlockK);  // in flight
    const int q_first = q_off + qt0;
    const int q_last = q_off + min(qt0 + kBlockK, t) - 1;
    if (has_row && (!causal || q_last >= k_pos)) {  // warp-uniform
      const bool live = qt0 + lane < t && (!causal || q_first + lane >= k_pos);
      float s, dp, p, ds;
      two_dots<D>(ks + warp * D, qT, vs + warp * D, doT, lane, s, dp);
      pair_grads(s, dp, lse_s[lane], dsum_s[lane], live, scale, p, ds);
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const int e = (lane + 32 * i) * kStride + j;
          acc_v[i] = __fmaf_rn(pj, doT[e], acc_v[i]);
          acc_k[i] = __fmaf_rn(dsj, qT[e], acc_k[i]);
        }
      }
    }
  }

  if (!has_row) return;
  const size_t row = kbase + key0 + warp;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    dk[row * D + lane + 32 * i] = from_f32<T>(acc_k[i]);
    dv[row * D + lane + 32 * i] = from_f32<T>(acc_v[i]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * D * kStride + 2 * kBwdWarps * D);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * D * kStride + 2 * kBwdWarps * D + 2 * kBlockK);
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int bh, int t,
              int tk, int q_off, int k_off, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<D, T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBwdWarps - 1) / kBwdWarps, bh);
  kernel<<<grid, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), t, tk, q_off, k_off, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dsum, void* dk, void* dv, int bh,
               int t, int tk, int q_off, int k_off, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<D, T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tk + kBwdWarps - 1) / kBwdWarps, bh);
  kernel<<<grid, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), t, tk, q_off, k_off, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success); an
// unsupported head dim or dtype returns cudaErrorInvalidValue without
// launching.
int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dsum,
                     void* dq, int bh, int t, int tk, int d, int dtype,
                     int q_off, int k_off, int causal, float scale,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DQ(D, T)                                                      \
  return launch_dq<D, T>(q, k, v, dout, lse, dsum, dq, bh, t, tk, q_off, \
                         k_off, causal, scale, s)
  if (d == 64 && dtype == kF32) RTT_DQ(64, float);
  if (d == 64 && dtype == kBF16) RTT_DQ(64, __nv_bfloat16);
  if (d == 128 && dtype == kF32) RTT_DQ(128, float);
  if (d == 128 && dtype == kBF16) RTT_DQ(128, __nv_bfloat16);
#undef RTT_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dk, void* dv, int bh, int t, int tk, int d,
                      int dtype, int q_off, int k_off, int causal, float scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_DKV(D, T)                                                          \
  return launch_dkv<D, T>(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, q_off, \
                          k_off, causal, scale, s)
  if (d == 64 && dtype == kF32) RTT_DKV(64, float);
  if (d == 64 && dtype == kBF16) RTT_DKV(64, __nv_bfloat16);
  if (d == 128 && dtype == kF32) RTT_DKV(128, float);
  if (d == 128 && dtype == kBF16) RTT_DKV(128, __nv_bfloat16);
#undef RTT_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
