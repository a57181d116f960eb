// Decode attention from an int8 KV cache for Hopper (sm_90a), split over the
// cache (flash-decoding), with a plain C interface for ctypes.
//
// Replaces, in raydp_tpu/ops/flash_attention.py:
//   flash_decode_int8  <- _decode_kernel_int8 via _decode_body, launched by
//                         pallas_call in flash_decode with int8 K/V and
//                         per-row f32 scales
//
// q [B*H, tq, D] (f32 or bf16), k/v [B*H, tk, D] int8 with scales
// [B*H, tk] f32, kv_len [B] (the valid rows of each sequence, including the
// tq new ones) -> o [B*H, tq, D] in q's type. Query row r sits at position
// kv_len - tq + r and attends the keys at positions <= its own and
// < min(kv_len, tk); a row with no such key gets 0.
//
// What bounds it on an H100: bytes. Every valid K/V row is read once, 128
// bytes plus a 4-byte scale each at D 128, and each element costs two
// operations: at the serving shape (4 sequences of 17-2048 rows, 8 heads)
// 8.2 MB, 0.0024 ms at 3.35 TB/s. The TPU kernel walks a sequence's cache
// in order in one grid row: ported as such, 32 blocks at the serving shape,
// one query row each, on a card of 132 SMs.
//
// The design:
// - One block per (b * h, chunk of kChunk keys): a few hundred blocks at the
//   serving shape. Blocks whose chunk starts at or past min(kv_len, tk)
//   exit at once.
// - The block stages its chunk's K and V rows in shared memory as int8 with
//   16-byte loads (8 threads a 128-byte row; K rows padded to kKPitch bytes
//   so that each thread's 16-byte reads of its own key row are free of bank
//   conflicts) and their scales as f32.
// - Per query row: thread j scores key j, dequantizing in registers as
//   __fmul_rn(float(k), scale) exactly as the plain version's f32 cache
//   does; the chunk's max and sum by warp shuffles and one pass over the
//   warps in order; thread d sums p_j * (float(v) * scale) over the chunk
//   for output element d. The chunk's (m, l, o) go to a workspace
//   [B*H, chunks, tq, 2 + D] f32 that the wrapper allocates.
// - The combine: the last block of each b * h to finish (an atomic ticket,
//   reset to 0 by that block for the next launch) merges the chunks in
//   chunk order: m = the max of the chunks' m, then l and o summed with
//   weights exp(m_c - m), chunk 0 first. The order is fixed, so two launches
//   give the same bits whichever block arrives last.
// An int8 cache row never equals a prefill row, so K4b carries no bitwise
// contract with the prefill; the f32 cache keeps it (flash_decode.cu).

#include "flash_common.cuh"

namespace {

constexpr int kChunk = 128;    // keys per block
constexpr int kThreads = 128;  // one per key (scores), one per element (p.v)

template <int D>
struct DecodeSmem {
  static constexpr int kKPitch = D + 16;  // bytes per staged K row
  int8_t k[kChunk * kKPitch];
  int8_t v[kChunk * D];
  float k_scale[kChunk];
  float v_scale[kChunk];
  float q[D];
  float p[kChunk];
  float red[kThreads / 32];
  int ticket;
};

// The block's max (exact in any order) and sum (each warp's butterfly sum,
// then the warps' sums in warp order) of one value per thread.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) out = fmaxf(out, red[w]);
  return out;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float out = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) out = __fadd_rn(out, red[w]);
  return out;
}

// grid (B*H, ceil(tk / kChunk)), kThreads threads.
template <int D, typename TQ>
__global__ void __launch_bounds__(kThreads)
flash_decode_int8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ kv_len, TQ* __restrict__ o,
                         float* __restrict__ part, int* __restrict__ tickets,
                         int heads, int tq, int tk, float scale) {
  using S = DecodeSmem<D>;
  __shared__ __align__(16) S sm;
  const int bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int len = kv_len[bh / heads];
  const int valid = max(0, min(len, tk));
  const int live_chunks = (valid + kChunk - 1) / kChunk;
  const int t = threadIdx.x;
  TQ* ob = o + static_cast<size_t>(bh) * tq * D;

  if (live_chunks == 0) {  // no live key: every row is 0
    if (chunk == 0) {
      for (int i = t; i < tq * D; i += kThreads) ob[i] = from_f32<TQ>(0.f);
    }
    return;
  }
  if (chunk >= live_chunks) return;

  const int key0 = chunk * kChunk;
  const int n_keys = min(kChunk, valid - key0);
  const size_t row0 = static_cast<size_t>(bh) * tk + key0;

  // stage the chunk: 16-byte pieces, D / 16 to a row; rows past the valid
  // ones are zeros
  for (int i = t; i < kChunk * (D / 16); i += kThreads) {
    const int j = i / (D / 16);
    const int c = (i % (D / 16)) * 16;
    int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
    if (j < n_keys) {
      kv = *reinterpret_cast<const int4*>(k + (row0 + j) * D + c);
      vv = *reinterpret_cast<const int4*>(v + (row0 + j) * D + c);
    }
    *reinterpret_cast<int4*>(sm.k + j * S::kKPitch + c) = kv;
    *reinterpret_cast<int4*>(sm.v + j * D + c) = vv;
  }
  sm.k_scale[t] = t < n_keys ? k_scale[row0 + t] : 0.f;
  sm.v_scale[t] = t < n_keys ? v_scale[row0 + t] : 0.f;

  float* pb = part + (static_cast<size_t>(bh) * n_chunks + chunk) * tq * (D + 2);
  for (int r = 0; r < tq; ++r) {
    __syncthreads();  // the chunk is staged; the previous row is done
    for (int d = t; d < D; d += kThreads) {
      sm.q[d] = to_f32(q[(static_cast<size_t>(bh) * tq + r) * D + d]);
    }
    __syncthreads();
    const int q_pos = len - tq + r;
    const bool live = t < n_keys && key0 + t <= q_pos;

    float s = 0.f;
    const float ks = sm.k_scale[t];
    const int8_t* kr = sm.k + t * S::kKPitch;
#pragma unroll 2
    for (int c = 0; c < D; c += 16) {
      const int4 raw = *reinterpret_cast<const int4*>(kr + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        s = __fmaf_rn(sm.q[c + e], __fmul_rn(static_cast<float>(b[e]), ks), s);
      }
    }
    s = live ? __fmul_rn(s, scale) : kNegInf;

    const float m_c = block_max(s, sm.red);
    const float p = live ? expf(__fsub_rn(s, m_c)) : 0.f;
    const float l_c = block_sum(p, sm.red);
    sm.p[t] = p;
    __syncthreads();

    for (int d = t; d < D; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < n_keys; ++j) {
        acc = __fmaf_rn(sm.p[j],
                        __fmul_rn(static_cast<float>(sm.v[j * D + d]), sm.v_scale[j]),
                        acc);
      }
      pb[r * (D + 2) + 2 + d] = acc;
    }
    if (t == 0) {
      pb[r * (D + 2)] = m_c;
      pb[r * (D + 2) + 1] = l_c;
    }
  }

  // the last block of this b * h to finish merges the chunks
  __threadfence();
  __syncthreads();
  if (t == 0) sm.ticket = atomicAdd(tickets + bh, 1);
  __syncthreads();
  if (sm.ticket != live_chunks - 1) return;
  __threadfence();
  const float* all = part + static_cast<size_t>(bh) * n_chunks * tq * (D + 2);
  for (int r = 0; r < tq; ++r) {
    float m = kNegInf;
    for (int j = 0; j < live_chunks; ++j) {
      m = fmaxf(m, __ldcg(all + (static_cast<size_t>(j) * tq + r) * (D + 2)));
    }
    for (int d = t; d < D; d += kThreads) {
      float l = 0.f, acc = 0.f;
      for (int c = 0; c < live_chunks; ++c) {
        const float* pc = all + (static_cast<size_t>(c) * tq + r) * (D + 2);
        const float w = expf(__fsub_rn(__ldcg(pc), m));
        l = __fmaf_rn(w, __ldcg(pc + 1), l);
        acc = __fmaf_rn(w, __ldcg(pc + 2 + d), acc);
      }
      ob[r * D + d] = from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
    }
  }
  if (t == 0) tickets[bh] = 0;  // ready for the next launch
}

template <int D, typename TQ>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* kv_len, void* o, float* part,
           int* tickets, int b, int h, int tq, int tk, float scale,
           cudaStream_t stream) {
  const dim3 grid(b * h, (tk + kChunk - 1) / kChunk);
  flash_decode_int8_kernel<D, TQ><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), k_scale, v_scale, kv_len,
      static_cast<TQ*>(o), part, tickets, h, tq, tk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_by_q(const void* q, const void* k, const void* v,
                const float* k_scale, const float* v_scale, const int* kv_len,
                void* o, float* part, int* tickets, int b, int h, int tq,
                int tk, int q_dtype, float scale, cudaStream_t stream) {
  if (q_dtype == kF32) {
    return launch<D, float>(q, k, v, k_scale, v_scale, kv_len, o, part,
                            tickets, b, h, tq, tk, scale, stream);
  }
  if (q_dtype == kBF16) {
    return launch<D, __nv_bfloat16>(q, k, v, k_scale, v_scale, kv_len, o, part,
                                    tickets, b, h, tq, tk, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// chunk must be the kernel's kChunk: the wrapper sizes the workspace `part`
// as [b * h, ceil(tk / chunk), tq, 2 + d] f32 and `tickets` as b * h zeroed
// int32 from it. Returns cudaGetLastError() after the launch (0 on success);
// an unsupported head dim, dtype or chunk returns cudaErrorInvalidValue
// without launching.
int rtt_flash_decode_int8(const void* q, const void* k, const void* v,
                          const float* k_scale, const float* v_scale,
                          const int* kv_len, void* o, void* part, void* tickets,
                          int b, int h, int tq, int tk, int d, int q_dtype,
                          int chunk, float scale, void* stream) {
  if (chunk != kChunk || b <= 0 || h <= 0 || tq <= 0 || tk <= 0 ||
      (tk + kChunk - 1) / kChunk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* ti = static_cast<int*>(tickets);
  if (d == 64) {
    return launch_by_q<64>(q, k, v, k_scale, v_scale, kv_len, o, pf, ti, b, h,
                           tq, tk, q_dtype, scale, s);
  }
  if (d == 128) {
    return launch_by_q<128>(q, k, v, k_scale, v_scale, kv_len, o, pf, ti, b, h,
                            tq, tk, q_dtype, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
