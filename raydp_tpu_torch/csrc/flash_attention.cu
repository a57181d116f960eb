// Flash attention for Hopper (sm_90a): the prefill forward and the decode
// kernels of the decode-serving path, with a plain C interface for ctypes.
//
// Replaces, in raydp_tpu/ops/flash_attention.py:
//   flash_fwd          <- _flash_kernel_onepass, launched by pallas_call in
//                         _flash_call (flash_attention / flash_attention_stats)
//   flash_fwd_twoterm  <- _flash_kernel, the same call with onepass=False
//                         (RAYDP_TPU_FLASH_ONEPASS=0): the same kernel with
//                         the two-term update, which always rescales
//   flash_decode       <- _decode_kernel via _decode_body, launched by
//                         pallas_call in flash_decode
//   flash_decode_int8  <- _decode_kernel_int8, the same call with int8 K/V and
//                         per-row f32 scales
//
// What bounds them on an H100. Prefill over T positions does 2*B*H*T^2*D
// operations (causal) on 4*B*H*T*D elements: at T = 2048, D = 128 that is
// about 500 operations per byte, above the card's ridge, so it is bound by
// operations. Decode reads every valid cached K/V row once and does two
// operations per element read: it is bound by bytes
// (sum(kv_len) * H * D * 2 * element size over 3.35 TB/s).
//
// What this design does about it: this first version is exact and simple,
// not fast. It computes in f32 on the CUDA cores (no tensor cores, no TMA):
// one warp per query row, one key per lane, K/V tiles of kBlockK keys staged
// in shared memory and shared by every row of the block; the next tile's
// loads are in flight, in registers, while the current one is computed.
// A loop over k-tiles
// inside the block replaces the TPU's sequential k-block grid axis, so the
// running (m, l, o) of a row stay in registers. Causal rows skip the k-tiles
// that lie entirely in their future; decode reads only the rows below each
// sequence's kv_len. Both kernels call the same per-row tile update
// (row_update) over the same k-tile partition, so a decode row equals the
// prefill row at the same position bit for bit on an f32 cache -- the
// failover contract of docs/serving.md ("Determinism and failover").
// Every rounding step is an explicit _rn intrinsic so that the compiler
// cannot contract the two kernels' arithmetic differently.
//
// The two-term body (kTwoTerm) computes alpha = exp(m - m_new) and
// fma(alpha, acc, pv) on every tile. Where the max did not move, alpha is
// exp(0) == 1 exactly and fma(1, a, b) rounds like a + b, so it equals the
// one-pass body bit for bit; it costs one exp and D/32 + 1 multiplies more
// per row and tile. Decode keeps the one-pass body.

#include "flash_common.cuh"

namespace {

constexpr int kFwdWarps = 16;  // prefill: query rows per block, one warp each
constexpr int kDecWarps = 4;   // decode: warps per block (rows, and K/V loads)

// Cache readers: element idx of row `row` as f32. Plain f32/bf16 values, or
// int8 values times the row's f32 scale (the inverse of quantize_int8).
template <typename T>
struct LoadPlain {
  const T* p;
  __device__ __forceinline__ float operator()(size_t idx, size_t) const {
    return to_f32(p[idx]);
  }
};

struct LoadInt8 {
  const int8_t* p;
  const float* scale;
  __device__ __forceinline__ float operator()(size_t idx, size_t row) const {
    return __fmul_rn(static_cast<float>(p[idx]), scale[row]);
  }
};

// One k-tile of K and V as f32, spread over the block's NT threads' registers.
// Loading the next tile into registers before the current one is computed,
// and storing it to shared memory after, keeps every thread's loads in
// flight together and overlaps them with the compute.
template <int D, int NT>
struct KVTile {
  static constexpr int kPer = kBlockK * D / NT;  // elements per thread
  float k[kPer];
  float v[kPer];
};

// Rows at or past n_valid are loaded as zeros: they are masked anyway, and
// zero V keeps p * v exact (0 * 0) where the cache holds stale or
// uninitialised values.
template <int D, int NT, class LK, class LV>
__device__ __forceinline__ void load_kv(const LK& lk, const LV& lv,
                                        size_t row0, int n_valid,
                                        KVTile<D, NT>& tile) {
#pragma unroll
  for (int u = 0; u < KVTile<D, NT>::kPer; ++u) {
    const int i = threadIdx.x + u * NT;
    const int j = i / D;
    const size_t row = row0 + j;
    const bool ok = j < n_valid;
    tile.k[u] = ok ? lk(row * D + i % D, row) : 0.f;
    tile.v[u] = ok ? lv(row * D + i % D, row) : 0.f;
  }
}

// Stage the tile: K transposed (kT[d][j], row stride kBlockK + 1 so that both
// these writes and the per-lane reads are free of bank conflicts), V as
// vt[j][d].
template <int D, int NT>
__device__ __forceinline__ void store_kv(const KVTile<D, NT>& tile, float* kT,
                                         float* vt) {
#pragma unroll
  for (int u = 0; u < KVTile<D, NT>::kPer; ++u) {
    const int i = threadIdx.x + u * NT;
    const int j = i / D;
    const int d = i % D;
    kT[d * (kBlockK + 1) + j] = tile.k[u];
    vt[j * D + d] = tile.v[u];
  }
}

// The per-row online-softmax update over one staged k-tile, shared by the
// prefill and decode kernels. Lane j scores key j; lane i holds output
// elements i, i + 32, ... The rescale of (l, o) runs only when the row max
// moved (the one-pass body of _flash_kernel_onepass); otherwise alpha would
// be exp(0) == 1 and the multiply is skipped as an exact identity. With
// kTwoTerm it always runs (the two-term body of _flash_kernel).
template <int D, bool kTwoTerm = false>
__device__ __forceinline__ void row_update(const float* qrow, const float* kT,
                                           const float* vt, bool key_live,
                                           float scale, float& m, float& l,
                                           float (&acc)[D / 32], int lane) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    s = __fmaf_rn(qrow[d], kT[d * (kBlockK + 1) + lane], s);
  }
  s = key_live ? __fmul_rn(s, scale) : kNegInf;

  const float block_max = warp_max(s);
  const float m_new = fmaxf(m, block_max);
  float p = expf(__fsub_rn(s, m_new));
  p = (s > kNegInf * 0.5f) ? p : 0.f;
  const float p_sum = warp_sum(p);

  float pv[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) pv[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kBlockK; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      pv[i] = __fmaf_rn(pj, vt[j * D + lane + 32 * i], pv[i]);
    }
  }

  if (kTwoTerm || block_max > m) {  // warp-uniform
    const float alpha = expf(__fsub_rn(m, m_new));
    l = __fmaf_rn(alpha, l, p_sum);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] = __fmaf_rn(alpha, acc[i], pv[i]);
  } else {
    l = __fadd_rn(l, p_sum);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] = __fadd_rn(acc[i], pv[i]);
  }
  m = m_new;
}

// Prefill: q [BH, T, D], k/v [BH, Tk, D] -> o [BH, T, D] (T, or f32 when
// out_f32), m/l [BH, T] f32. grid (ceil(T / kFwdWarps), BH).
template <int D, typename T, bool kTwoTerm>
__global__ void __launch_bounds__(kFwdWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int t,
                 int tk, int q_off, int k_off, int causal, int normalize,
                 int out_f32, float scale) {
  extern __shared__ float smem[];
  float* kT = smem;                     // D x (kBlockK + 1)
  float* vt = kT + D * (kBlockK + 1);   // kBlockK x D
  float* qs = vt + kBlockK * D;         // kFwdWarps x D

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * kFwdWarps;
  const int rows = min(kFwdWarps, t - row0);
  const size_t qbase = bh * t;
  const size_t kbase = bh * tk;
  stage_rows<D>(q, qbase + row0, rows, kFwdWarps, qs);

  const bool has_row = warp < rows;
  const int q_pos = q_off + row0 + warp;
  int k_end = tk;  // keys [0, k_end) can be live for some row of the block
  if (causal) k_end = max(0, min(tk, q_off + row0 + rows - k_off));
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  float m = kNegInf;
  float l = 0.f;
  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;

  const LoadPlain<T> lk{k};
  const LoadPlain<T> lv{v};
  KVTile<D, kFwdWarps * 32> tile;
  if (n_tiles > 0) load_kv(lk, lv, kbase, min(kBlockK, tk), tile);
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int kt0 = ti * kBlockK;
    __syncthreads();  // the previous tile is consumed; q is staged
    store_kv(tile, kT, vt);
    __syncthreads();
    if (ti + 1 < n_tiles) {  // in flight while this tile is computed
      load_kv(lk, lv, kbase + kt0 + kBlockK, min(kBlockK, tk - kt0 - kBlockK),
              tile);
    }
    const int k_first = k_off + kt0;
    if (has_row && (!causal || q_pos >= k_first)) {
      const bool live =
          kt0 + lane < tk && (!causal || q_pos >= k_first + lane);
      row_update<D, kTwoTerm>(qs + warp * D, kT, vt, live, scale, m, l, acc,
                              lane);
    }
  }

  if (!has_row) return;
  const size_t row = qbase + row0 + warp;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const float x = normalize ? __fdiv_rn(acc[i], denom) : acc[i];
    const size_t idx = row * D + lane + 32 * i;
    if (out_f32) {
      static_cast<float*>(o)[idx] = x;
    } else {
      static_cast<T*>(o)[idx] = from_f32<T>(x);
    }
  }
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

// Decode: the newest tq query rows of each sequence against a cache of
// capacity tk with per-sequence valid lengths kv_len [B] (including the tq
// new rows). q [B*H, tq, D], K/V read through the loaders, o [B*H, tq, D] in
// q's type. grid (ceil(tq / kDecWarps), B*H).
template <int D, typename TQ, class LK, class LV>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const TQ* __restrict__ q, LK lk, LV lv,
                    const int* __restrict__ kv_len, TQ* __restrict__ o,
                    int heads, int tq, int tk, float scale) {
  extern __shared__ float smem[];
  float* kT = smem;
  float* vt = kT + D * (kBlockK + 1);
  float* qs = vt + kBlockK * D;  // kDecWarps x D

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int len = kv_len[bh / heads];
  const int row0 = blockIdx.x * kDecWarps;
  const int rows = min(kDecWarps, tq - row0);
  const size_t qbase = bh * tq;
  const size_t kbase = bh * tk;
  stage_rows<D>(q, qbase + row0, rows, kDecWarps, qs);

  const bool has_row = warp < rows;
  const int q_pos = len - tq + row0 + warp;
  const int valid = min(len, tk);
  const int n_tiles = valid > 0 ? (valid + kBlockK - 1) / kBlockK : 0;

  float m = kNegInf;
  float l = 0.f;
  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;

  KVTile<D, kDecWarps * 32> tile;
  if (n_tiles > 0) load_kv(lk, lv, kbase, min(kBlockK, valid), tile);
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int kt0 = ti * kBlockK;
    __syncthreads();
    store_kv(tile, kT, vt);
    __syncthreads();
    if (ti + 1 < n_tiles) {
      load_kv(lk, lv, kbase + kt0 + kBlockK,
              min(kBlockK, valid - kt0 - kBlockK), tile);
    }
    if (has_row && q_pos >= kt0) {
      const bool live = kt0 + lane < valid && q_pos >= kt0 + lane;
      row_update<D>(qs + warp * D, kT, vt, live, scale, m, l, acc, lane);
    }
  }

  if (!has_row) return;
  const size_t row = qbase + row0 + warp;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    o[row * D + lane + 32 * i] = from_f32<TQ>(__fdiv_rn(acc[i], denom));
  }
}

template <int D>
constexpr size_t smem_bytes(int q_rows) {
  return sizeof(float) * (D * (kBlockK + 1) + kBlockK * D + q_rows * D);
}

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* m,
               float* l, int bh, int t, int tk, int q_off, int k_off,
               int causal, int normalize, int out_f32, int onepass,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(kFwdWarps);
  auto kernel = onepass ? flash_fwd_kernel<D, T, false>
                        : flash_fwd_kernel<D, T, true>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kFwdWarps - 1) / kFwdWarps, bh);
  kernel<<<grid, kFwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, m, l, t, tk, q_off, k_off, causal,
      normalize, out_f32, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TQ, class LK, class LV>
int launch_decode(const void* q, LK lk, LV lv, const int* kv_len, void* o,
                  int b, int h, int tq, int tk, float scale,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(kDecWarps);
  auto kernel = flash_decode_kernel<D, TQ, LK, LV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + kDecWarps - 1) / kDecWarps, b * h);
  kernel<<<grid, kDecWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), lk, lv, kv_len, static_cast<TQ*>(o), h, tq,
      tk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename TQ>
int decode_by_cache(const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale,
                    const int* kv_len, void* o, int b, int h, int tq, int tk,
                    int kv_dtype, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch_decode<D, TQ>(
          q, LoadPlain<float>{static_cast<const float*>(k)},
          LoadPlain<float>{static_cast<const float*>(v)}, kv_len, o, b, h, tq,
          tk, scale, stream);
    case kBF16:
      return launch_decode<D, TQ>(
          q, LoadPlain<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k)},
          LoadPlain<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(v)},
          kv_len, o, b, h, tq, tk, scale, stream);
    case kI8:
      return launch_decode<D, TQ>(
          q, LoadInt8{static_cast<const int8_t*>(k), k_scale},
          LoadInt8{static_cast<const int8_t*>(v), v_scale}, kv_len, o, b, h,
          tq, tk, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int decode_by_q(const void* q, const void* k, const void* v,
                const float* k_scale, const float* v_scale, const int* kv_len,
                void* o, int b, int h, int tq, int tk, int q_dtype,
                int kv_dtype, float scale, cudaStream_t stream) {
  if (q_dtype == kF32) {
    return decode_by_cache<D, float>(q, k, v, k_scale, v_scale, kv_len, o, b,
                                     h, tq, tk, kv_dtype, scale, stream);
  }
  if (q_dtype == kBF16) {
    return decode_by_cache<D, __nv_bfloat16>(q, k, v, k_scale, v_scale,
                                             kv_len, o, b, h, tq, tk,
                                             kv_dtype, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success); an unsupported
// head dim or dtype returns cudaErrorInvalidValue without launching.
// onepass = 0 launches the two-term body (flash_fwd_twoterm).
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* m, float* l, int bh, int t, int tk, int d, int dtype,
                  int q_off, int k_off, int causal, int normalize, int out_f32,
                  int onepass, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_FWD(D, T)                                                         \
  return launch_fwd<D, T>(q, k, v, o, m, l, bh, t, tk, q_off, k_off, causal, \
                          normalize, out_f32, onepass, scale, s)
  if (d == 64 && dtype == kF32) RTT_FWD(64, float);
  if (d == 64 && dtype == kBF16) RTT_FWD(64, __nv_bfloat16);
  if (d == 128 && dtype == kF32) RTT_FWD(128, float);
  if (d == 128 && dtype == kBF16) RTT_FWD(128, __nv_bfloat16);
#undef RTT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_flash_decode(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* kv_len, void* o, int b, int h, int tq, int tk,
                     int d, int q_dtype, int kv_dtype, float scale,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    return decode_by_q<64>(q, k, v, k_scale, v_scale, kv_len, o, b, h, tq, tk,
                           q_dtype, kv_dtype, scale, s);
  }
  if (d == 128) {
    return decode_by_q<128>(q, k, v, k_scale, v_scale, kv_len, o, b, h, tq,
                            tk, q_dtype, kv_dtype, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
