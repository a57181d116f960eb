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
//   16-byte loads (8 threads a 128-byte row; 8-byte loads at D 8, whose row
//   is 8 bytes; K rows padded to kKPitch bytes so that each thread's reads
//   of its own key row are free of bank conflicts) and their scales as f32.
// - D is 8, 16, 32, 64, 128 or 256 (any other D up to 256 arrives
//   zero-padded by the wrapper: a zero int8 value adds an exact 0 to the
//   score's chain; the scales are per row and unchanged). Below D 128 the
//   threads past D sit out the p.v stage and the merge, which keep their
//   order; at D 256 each thread takes elements t and t + 128.
// - The staging lives in dynamic shared memory (DecodeSmem, 70 KB at D
//   256, past the 48 KB a kernel may hold statically).
// - Head dims past 256 arrive zero-padded by the wrapper to a multiple of
//   kHeadChunk (256) and run the D 256 instantiation's chunked body
//   (kChunked), in the D 256 body's shared memory: a grid axis over the
//   output's 256-column chunks; each block stages its chunk of the V rows
//   once, and for each query row stages the K rows and q one 256-column
//   chunk at a time, thread j carrying key j's score chain from chunk to
//   chunk (the row scale inside each product, as at D 256), then p and p.v
//   of its columns. Every column chunk's block computes the same (m, l);
//   the chunk-0 block writes them. The last of the live chunks x column
//   chunks blocks of a b * h merges every column.
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

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kChunk = 128;    // keys per block
constexpr int kThreads = 128;  // one per key (scores), one per element (p.v)

// The int8 elements a thread moves at once: 16 (an int4), or the whole row
// of 8 at D 8 (an int2).
template <int D>
struct Piece {
  static constexpr int kBytes = D < 16 ? D : 16;
  using T = typename std::conditional<(D < 16), int2, int4>::type;
};

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

// One piece (Piece<D>) of an int8 row from `src` to `dst`, zeros where
// !ok.
template <int D>
__device__ __forceinline__ void stage_piece(const int8_t* src, int8_t* dst,
                                            bool ok) {
  using P = typename Piece<D>::T;
  P x = {};
  if (ok) x = *reinterpret_cast<const P*>(src);
  *reinterpret_cast<P*>(dst) = x;
}

// grid (B*H, ceil(tk / kChunk)), kThreads threads; kChunked: a third axis
// over the output's D-wide column chunks, and rows of d_total = n * D
// elements.
template <int D, typename TQ, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_decode_int8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ kv_len, TQ* __restrict__ o,
                         float* __restrict__ part, int* __restrict__ tickets,
                         int heads, int tq, int tk, int d_total, float scale) {
  using S = DecodeSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int dt = kChunked ? d_total : D;  // a row's elements
  const int n_dc = kChunked ? d_total / D : 1;
  const int n_out = kChunked ? static_cast<int>(gridDim.z) : 1;
  const int col0 = kChunked ? static_cast<int>(blockIdx.z) * D : 0;
  const int len = kv_len[bh / heads];
  const int valid = max(0, min(len, tk));
  const int live_chunks = (valid + kChunk - 1) / kChunk;
  const int t = threadIdx.x;
  TQ* ob = o + static_cast<size_t>(bh) * tq * dt;

  if (live_chunks == 0) {  // no live key: every row is 0
    if (chunk == 0 && col0 == 0) {
      for (int i = t; i < tq * dt; i += kThreads) ob[i] = from_f32<TQ>(0.f);
    }
    return;
  }
  if (chunk >= live_chunks) return;

  const int key0 = chunk * kChunk;
  const int n_keys = min(kChunk, valid - key0);
  const size_t row0 = static_cast<size_t>(bh) * tk + key0;

  // stage the chunk (kChunked: the V rows' columns of this block, the K
  // rows one column chunk at a time below): pieces of kPiece bytes, D /
  // kPiece to a row; rows past the valid ones are zeros
  using P = typename Piece<D>::T;
  constexpr int kPiece = Piece<D>::kBytes;
  constexpr int kPieces = D / kPiece;
  for (int i = t; i < kChunk * kPieces; i += kThreads) {
    const int j = i / kPieces;
    const int c = (i % kPieces) * kPiece;
    if (!kChunked) {
      stage_piece<D>(k + (row0 + j) * D + c, sm.k + j * S::kKPitch + c,
                     j < n_keys);
    }
    stage_piece<D>(v + (row0 + j) * dt + col0 + c, sm.v + j * D + c,
                   j < n_keys);
  }
  sm.k_scale[t] = t < n_keys ? k_scale[row0 + t] : 0.f;
  sm.v_scale[t] = t < n_keys ? v_scale[row0 + t] : 0.f;

  float* pb = part + (static_cast<size_t>(bh) * n_chunks + chunk) * tq * (dt + 2);
  for (int r = 0; r < tq; ++r) {
    const int q_pos = len - tq + r;
    const bool live = t < n_keys && key0 + t <= q_pos;
    const float ks = sm.k_scale[t];
    const int8_t* kr = sm.k + t * S::kKPitch;
    float s = 0.f;  // one chain over every column chunk
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // the chunk is staged; the previous row (or column
                        // chunk) is done
      if (kChunked) {
        for (int i = t; i < kChunk * kPieces; i += kThreads) {
          const int j = i / kPieces;
          const int c = (i % kPieces) * kPiece;
          stage_piece<D>(k + (row0 + j) * dt + dc * D + c,
                         sm.k + j * S::kKPitch + c, j < n_keys);
        }
      }
      for (int d = t; d < D; d += kThreads) {
        sm.q[d] = to_f32(q[(static_cast<size_t>(bh) * tq + r) * dt + dc * D + d]);
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < D; c += kPiece) {
        const P raw = *reinterpret_cast<const P*>(kr + c);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          s = __fmaf_rn(sm.q[c + e], __fmul_rn(static_cast<float>(b[e]), ks), s);
        }
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
      pb[r * (dt + 2) + 2 + col0 + d] = acc;
    }
    if (t == 0 && col0 == 0) {
      pb[r * (dt + 2)] = m_c;
      pb[r * (dt + 2) + 1] = l_c;
    }
  }

  // the last block of this b * h to finish (of every column chunk) merges
  // the chunks
  __threadfence();
  __syncthreads();
  if (t == 0) sm.ticket = atomicAdd(tickets + bh, 1);
  __syncthreads();
  if (sm.ticket != live_chunks * n_out - 1) return;
  __threadfence();
  const float* all = part + static_cast<size_t>(bh) * n_chunks * tq * (dt + 2);
  for (int r = 0; r < tq; ++r) {
    float m = kNegInf;
    for (int j = 0; j < live_chunks; ++j) {
      m = fmaxf(m, __ldcg(all + (static_cast<size_t>(j) * tq + r) * (dt + 2)));
    }
    for (int d = t; d < dt; d += kThreads) {
      float l = 0.f, acc = 0.f;
      for (int c = 0; c < live_chunks; ++c) {
        const float* pc = all + (static_cast<size_t>(c) * tq + r) * (dt + 2);
        const float w = expf(__fsub_rn(__ldcg(pc), m));
        l = __fmaf_rn(w, __ldcg(pc + 1), l);
        acc = __fmaf_rn(w, __ldcg(pc + 2 + d), acc);
      }
      ob[r * dt + d] = from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
    }
  }
  if (t == 0) tickets[bh] = 0;  // ready for the next launch
}

// kChunked: the head dim is d_total, a multiple of D (the chunk width).
template <int D, bool kChunked, typename TQ>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* kv_len, void* o, float* part,
           int* tickets, int b, int h, int tq, int tk, int d_total,
           float scale, cudaStream_t stream) {
  auto kernel = flash_decode_int8_kernel<D, TQ, kChunked>;
  const size_t smem = sizeof(DecodeSmem<D>);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (tk + kChunk - 1) / kChunk, d_total / D);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), k_scale, v_scale, kv_len,
      static_cast<TQ*>(o), part, tickets, h, tq, tk, d_total, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kChunked = false>
int launch_by_q(const void* q, const void* k, const void* v,
                const float* k_scale, const float* v_scale, const int* kv_len,
                void* o, float* part, int* tickets, int b, int h, int tq,
                int tk, int d_total, int q_dtype, float scale,
                cudaStream_t stream) {
  if (q_dtype == kF32) {
    return launch<D, kChunked, float>(q, k, v, k_scale, v_scale, kv_len, o,
                                      part, tickets, b, h, tq, tk, d_total,
                                      scale, stream);
  }
  if (q_dtype == kBF16) {
    return launch<D, kChunked, __nv_bfloat16>(q, k, v, k_scale, v_scale,
                                              kv_len, o, part, tickets, b, h,
                                              tq, tk, d_total, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// chunk must be the kernel's kChunk: the wrapper sizes the workspace `part`
// as [b * h, ceil(tk / chunk), tq, 2 + d] f32 and `tickets` as b * h zeroed
// int32 from it. Returns cudaGetLastError() after the launch (0 on success);
// an unsupported head dim, dtype or chunk returns cudaErrorInvalidValue
// without launching. The head dims built (the `case`s below,
// ops/flash_attention.py KERNEL_HEAD_DIMS): 8, 16, 32, 64, 128 and 256; a
// multiple of kHeadChunk past 256 runs the chunked body.
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
#define RTT_INT8(D)                                                          \
  return launch_by_q<D>(q, k, v, k_scale, v_scale, kv_len, o, pf, ti, b, h, \
                        tq, tk, D, q_dtype, scale, s)
  switch (d) {
    case 8: RTT_INT8(8);
    case 16: RTT_INT8(16);
    case 32: RTT_INT8(32);
    case 64: RTT_INT8(64);
    case 128: RTT_INT8(128);
    case 256: RTT_INT8(256);
  }
#undef RTT_INT8
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_by_q<kHeadChunk, true>(q, k, v, k_scale, v_scale, kv_len, o,
                                         pf, ti, b, h, tq, tk, d, q_dtype,
                                         scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
