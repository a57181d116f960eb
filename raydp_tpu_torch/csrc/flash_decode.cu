// Decode attention from an f32 or bf16 KV cache for Hopper (sm_90a), split
// over the cache, with the bits of the sequential row update kept, and a
// plain C interface for ctypes.
//
// Replaces, in raydp_tpu/ops/flash_attention.py:
//   flash_decode  <- _decode_kernel via _decode_body, launched by pallas_call
//                    in flash_decode, for f32 and bf16 caches (the int8
//                    cache has its own kernel: flash_decode_int8.cu)
//
// q [B*H, tq, D] (f32 or bf16), k/v [B*H, tk, D] (f32 or bf16), kv_len [B]
// (the valid rows of each sequence, including the tq new ones) -> o
// [B*H, tq, D] in q's type. Query row r sits at position kv_len - tq + r
// and attends the keys at positions <= its own and < min(kv_len, tk); a row
// with no such key gets 0. Cache rows at or past kv_len are read as zeros,
// so stale values (NaN, inf) never reach the sums. D is 8, 16, 32, 64, 128
// or 256 for every pair of types (any other D up to 256 arrives
// zero-padded by the wrapper to the next of these); below D 32 the lanes
// past D repeat a lower lane's p.v element and store nothing, so each
// element keeps its one chain. At D 256 a block stages 4 x 32 K rows of
// 1040 bytes (f32 cache, 137 KB of dynamic shared memory) or V rows of
// 1024 bytes (131 KB): one block an SM, 8 p.v elements a lane.
//
// Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512) arrive
// zero-padded by the wrapper to a multiple of kHeadChunk (256) and run the
// D 256 instantiation's chunked body (kChunked), whose shared memory is
// the D 256 body's whatever the width:
// - the scores kernel stages its tile's K rows one 256-column chunk at a
//   time; each (row, key) score is one chain over d ascending across the
//   chunks, its running value kept in the workspace's score slot between
//   chunks (an f32 store and load change no bit), scaled and masked after
//   the last;
// - the p.v kernel has a grid axis over the output's 256-column chunks:
//   each block stages its chunk of the V rows, computes the tile's p (the
//   same in every chunk's block) and p.v of its columns; the chunk-0 block
//   writes the tile's alpha and sum of p. The last of the live_chunks x
//   n_out blocks of a b * h merges every column, as at D 256.
// So the decode row keeps the prefill row's bits at every D.
//
// What bounds it on an H100: bytes. Every valid K/V row is read once and
// each element costs two operations: at the serving shape (4 sequences of
// 17-2048 rows, 8 heads of 128, an f32 cache) 31.7 MB, 9.45 us at 3.35 TB/s.
// The TPU kernel walks a sequence's cache in order in one grid row; ported
// as such it ran 32 blocks at the serving shape on a card of 132 SMs.
//
// The contract it keeps: for every row the output equals the prefill's
// (flash_attention.cu's f32 body): the steps of flash_common.cuh over the
// row's 32-key tiles in order, then __fdiv_rn(o, max(l, 1e-30)) rounded to
// q's type. So an f32 decode row equals the f32 prefill row at its position
// bit for bit (docs/serving.md, "Determinism and failover"). Those steps
// split into parallel work and a short sequential tail:
//   1. each tile's scores and its max (tile_score, warp_max): lane j scores
//      key j;
//   2. the row max before each tile, M_{t-1}, and at it, M_t = max(M_{t-1},
//      tile max t): a max is exact in any order, so these are the running
//      maxima the sequential update sees;
//   3. each tile's p = exp(s - M_t) (tile_prob), its sum (warp_sum) and p.v
//      (tile_pv), which depend on no other tile given M_t, and its alpha =
//      exp(M_{t-1} - M_t) where the max moved (tile_alpha);
//   4. the merges (merge_term) in tile order, rescaling where the max moved
//      and adding where it did not, as the sequential update does.
//
// The design, two launches:
// - flash_decode_scores_kernel: one block per (b * h, chunk of kChunk
//   keys), one warp per 32-key tile. Each warp stages its tile's K rows in
//   shared memory with 16-byte cp.async copies (zero-filled past the valid
//   rows; rows padded by 16 bytes, so that each lane's 16-byte reads of its
//   own key row are free of bank conflicts), then for each query row writes
//   the tile's scores and its max to a workspace (step 1).
// - flash_decode_pv_kernel: the same grid. Each warp stages its tile's V
//   rows the same way and, while they arrive, reads the row's earlier tile
//   maxima (one per lane) for M_{t-1}; then step 3, writing (alpha, or -1
//   where the max did not move; the sum of p; p.v) to the workspace. The
//   last block of each b * h to finish (an atomic ticket, reset to 0 by that
//   block for the next launch) runs step 4: each warp takes one (row, 32
//   elements) and merges the row's tiles in order, 32 tiles' partials loaded
//   at a time.
// Blocks whose chunk starts at or past min(kv_len, tk) exit at once: at the
// serving shape 256 of 512 blocks are live in each launch. No block waits
// for another. The order of every sum is fixed, so two launches give the
// same bits whichever block arrives last.

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;                 // tiles per block, one warp each
constexpr int kChunk = kWarps * kBlockK;  // keys per block
constexpr int kThreads = kWarps * 32;
// workspace floats per (row, tile): the scores, the tile max, and (alpha,
// sum of p, p.v[D])
constexpr int kWorkPerTile = kBlockK + 1 + 2;

// 16 bytes from global to shared memory, bypassing L1; src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Wait for the warp's copies (stage_tile), then make them visible to the
// whole warp.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// One warp starts copying 32 rows of D elements from `src` (row pitch
// `src_pitch` elements: D, or the padded head dim of a chunked body) into
// shared memory at `dst` (row pitch `pitch` bytes), 16 bytes a copy; rows
// at or past `rows` are zeros. staged() waits for them.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(const T* src, int src_pitch,
                                           int rows, unsigned char* dst,
                                           int pitch, int lane) {
  constexpr int kPieces = D * sizeof(T) / 16;  // 16-byte pieces per row
  const unsigned char* g = reinterpret_cast<const unsigned char*>(src);
  for (int i = lane; i < kBlockK * kPieces; i += 32) {
    const int j = i / kPieces;
    const int c = (i % kPieces) * 16;
    const bool ok = j < rows;
    cp_async16(dst + j * pitch + c,
               g + static_cast<size_t>(ok ? j : 0) * src_pitch * sizeof(T) + c,
               ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes of f32 or bf16 elements as f32 (a bf16 is the high half of its
// f32, as __bfloat162float converts it).
__device__ __forceinline__ void unpack16(const uint4& raw, float (&k)[4]) {
  k[0] = __uint_as_float(raw.x);
  k[1] = __uint_as_float(raw.y);
  k[2] = __uint_as_float(raw.z);
  k[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&k)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k[2 * i] = __uint_as_float(w[i] << 16);
    k[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A staged key row read 16 bytes at a time (tile_score's krow).
template <typename T>
struct StagedKey {
  static constexpr int kGroup = 16 / sizeof(T);
  const T* row;
  __device__ __forceinline__ void operator()(int c, float (&k)[kGroup]) const {
    unpack16(*reinterpret_cast<const uint4*>(row + c), k);
  }
};

template <int D, typename TK>
struct ScoresSmem {
  static constexpr int kPitch = D * sizeof(TK) + 16;  // bytes per K row
  static constexpr int kTile = kBlockK * kPitch;
  static constexpr size_t kBytes = kWarps * kTile + kWarps * D * sizeof(float);
};

// Step 1. grid (B*H, ceil(tk / kChunk)), kThreads threads. s_out [B*H, tq,
// n_tiles * kBlockK], tmax_out [B*H, tq, n_tiles], n_tiles = ceil(tk /
// kBlockK). kChunked: q and k have rows of d_total = n * D elements, staged
// D columns at a time.
template <int D, typename TQ, typename TK, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_decode_scores_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
                           const int* __restrict__ kv_len,
                           float* __restrict__ s_out,
                           float* __restrict__ tmax_out, int heads, int tq,
                           int tk, int n_tiles, int d_total, float scale) {
  using S = ScoresSmem<D, TK>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.x;
  const int len = kv_len[bh / heads];
  const int valid = max(0, min(len, tk));
  const int tile = blockIdx.y * kWarps + warp;
  const int kt0 = tile * kBlockK;
  if (kt0 >= valid) return;  // no block-wide barrier follows
  const int dt = kChunked ? d_total : D;  // a row's elements
  const int n_dc = kChunked ? d_total / D : 1;

  unsigned char* ks = smem + warp * S::kTile;
  float* qs = reinterpret_cast<float*>(smem + kWarps * S::kTile) + warp * D;
  const StagedKey<TK> krow{reinterpret_cast<const TK*>(ks + lane * S::kPitch)};
  const int key = kt0 + lane;
  for (int dc = 0; dc < n_dc; ++dc) {
    if (dc > 0) __syncwarp();  // the last chunk's K rows are read
    stage_tile<D>(k + (bh * tk + kt0) * dt + dc * D, dt, valid - kt0, ks,
                  S::kPitch, lane);
    staged();
    const bool last = dc == n_dc - 1;
    for (int r = 0; r < tq; ++r) {
      const int q_pos = len - tq + r;
      if (q_pos < kt0) continue;  // the tile lies in the row's future
      const TQ* qg = q + (bh * tq + r) * dt + dc * D;
      for (int d = lane; d < D; d += 32) qs[d] = to_f32(qg[d]);
      __syncwarp();
      const size_t row = bh * tq + r;
      float* s_at = s_out + row * n_tiles * kBlockK + key;
      // the chain so far: 0, or the running sum the last chunk left
      float s = score_chain<D, StagedKey<TK>::kGroup>(
          qs, krow, dc == 0 ? 0.f : *s_at);
      if (last) {
        const bool live = key < valid && q_pos >= key;
        s = live ? __fmul_rn(s, scale) : kNegInf;
        const float tile_max = warp_max(s);
        if (lane == 0) tmax_out[row * n_tiles + tile] = tile_max;
      }
      *s_at = s;
      __syncwarp();  // qs is read before the next row overwrites it
    }
  }
}

template <int D, typename TK>
struct PvSmem {
  static constexpr int kPitch = D * sizeof(TK);  // bytes per V row
  static constexpr int kTile = kBlockK * kPitch;
  static constexpr size_t kBytes = kWarps * kTile;
};

// Steps 2-4. The same grid (kChunked: a third axis over the output's D-wide
// column chunks, n_out = d_total / D). part [B*H, tq, n_tiles, 2 + d_total];
// tickets [B*H] zeroed int32.
template <int D, typename TQ, typename TK, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_decode_pv_kernel(const TK* __restrict__ v, const int* __restrict__ kv_len,
                       const float* __restrict__ s_in,
                       const float* __restrict__ tmax_in,
                       float* __restrict__ part, int* __restrict__ tickets,
                       TQ* __restrict__ o, int heads, int tq, int tk,
                       int n_tiles, int d_total) {
  using S = PvSmem<D, TK>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.x;
  const int chunk = blockIdx.y;
  const int dt = kChunked ? d_total : D;  // a row's elements
  const int n_out = kChunked ? static_cast<int>(gridDim.z) : 1;
  const int col0 = kChunked ? static_cast<int>(blockIdx.z) * D : 0;
  const int len = kv_len[bh / heads];
  const int valid = max(0, min(len, tk));
  const int live_chunks = (valid + kChunk - 1) / kChunk;
  TQ* ob = o + bh * tq * dt;

  if (live_chunks == 0) {  // no live key: every row is 0
    if (chunk == 0 && col0 == 0) {
      for (int i = threadIdx.x; i < tq * dt; i += kThreads) ob[i] = from_f32<TQ>(0.f);
    }
    return;
  }
  if (chunk >= live_chunks) return;

  const int tile = chunk * kWarps + warp;
  const int kt0 = tile * kBlockK;
  if (kt0 < valid) {
    const TK* vs = reinterpret_cast<const TK*>(smem + warp * S::kTile);
    stage_tile<D>(v + (bh * tk + kt0) * dt + col0, dt, valid - kt0,
                  smem + warp * S::kTile, S::kPitch, lane);
    for (int r = 0; r < tq; ++r) {
      const int q_pos = len - tq + r;
      if (q_pos < kt0) continue;  // the tile lies in the row's future
      const size_t row = bh * tq + r;
      const float* tm = tmax_in + row * n_tiles;
      // M_{t-1} over the row's earlier tiles, one per lane
      float m_prev = kNegInf;
      for (int u = lane; u < tile; u += 32) m_prev = fmaxf(m_prev, tm[u]);
      m_prev = warp_max(m_prev);
      const float tile_max = tm[tile];
      const float m_new = fmaxf(m_prev, tile_max);
      const float p = tile_prob(s_in[row * n_tiles * kBlockK + kt0 + lane], m_new);
      const float p_sum = warp_sum(p);
      staged();  // V, in flight since before the loop
      float pv[lane_elems<D>()];
      tile_pv<D>(p, [&](int j, int e) { return to_f32(vs[j * D + e]); }, lane, pv);
      const bool moved = tile_max > m_prev;
      float* pt = part + (row * n_tiles + tile) * (2 + dt);
      if (lane == 0 && col0 == 0) {
        pt[0] = moved ? tile_alpha(m_prev, m_new) : -1.f;
        pt[1] = p_sum;
      }
      if (lane_owns<D>(lane)) {
#pragma unroll
        for (int i = 0; i < lane_elems<D>(); ++i) {
          pt[2 + col0 + lane + 32 * i] = pv[i];
        }
      }
    }
  }

  // the last block of this b * h to finish (of every column chunk) merges
  // the tiles
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(tickets + bh, 1);
  __syncthreads();
  if (ticket != live_chunks * n_out - 1) return;
  __threadfence();
  const int row_tiles = (valid + kBlockK - 1) / kBlockK;
  // 32-element parts of a row
  const int parts = kChunked ? dt / 32 : lane_elems<D>();
  for (int item = warp; item < tq * parts; item += kWarps) {
    const int r = item / parts;
    const int e = kChunked ? lane + 32 * (item % parts)
                           : lane_elem<D>(lane, item % parts);
    const int q_pos = len - tq + r;
    // the row's tiles: those starting at or before its position
    const int n = q_pos < 0 ? 0 : min(row_tiles, q_pos / kBlockK + 1);
    const float* pr = part + (bh * tq + r) * n_tiles * (2 + dt);
    float l = 0.f, acc = 0.f;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int count = min(32, n - t0);
      const float* pb = pr + static_cast<size_t>(t0) * (2 + dt);
      // lane u holds tile t0 + u's alpha and sum of p; every lane its
      // element of each tile's p.v
      const float alpha_u = lane < count ? __ldcg(pb + lane * (2 + dt)) : 0.f;
      const float p_sum_u = lane < count ? __ldcg(pb + lane * (2 + dt) + 1) : 0.f;
      // from D 64 the 32 tiles' elements are loaded ahead of the merges;
      // below it (a row of one part) each is loaded at its merge, which
      // keeps ptxas from spilling the D 32 body
      constexpr int kAhead = D >= 64 ? 32 : 1;
      float pv[kAhead];
      if constexpr (D >= 64) {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          pv[u] = u < count ? __ldcg(pb + u * (2 + dt) + 2 + e) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float alpha = __shfl_sync(kFull, alpha_u, u);
        const float p_sum = __shfl_sync(kFull, p_sum_u, u);
        if (u < count) {  // warp-uniform
          const bool moved = alpha >= 0.f;
          l = merge_term(moved, alpha, l, p_sum);
          if constexpr (D >= 64) {
            acc = merge_term(moved, alpha, acc, pv[u]);
          } else {
            acc = merge_term(moved, alpha, acc,
                             __ldcg(pb + u * (2 + dt) + 2 + e));
          }
        }
      }
    }
    if (lane_owns<D>(lane)) {
      ob[r * dt + e] = from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
    }
  }
  if (threadIdx.x == 0) tickets[bh] = 0;  // ready for the next launch
}

// kChunked: the head dim is d_total, a multiple of D (the chunk width).
template <int D, bool kChunked, typename TQ, typename TK>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, float* work, int* tickets, int b, int h, int tq, int tk,
           int d_total, float scale, cudaStream_t stream) {
  auto scores = flash_decode_scores_kernel<D, TQ, TK, kChunked>;
  auto pv = flash_decode_pv_kernel<D, TQ, TK, kChunked>;
  const size_t scores_smem = ScoresSmem<D, TK>::kBytes;
  const size_t pv_smem = PvSmem<D, TK>::kBytes;
  cudaError_t err = prepare(scores, scores_smem);
  if (err == cudaSuccess) err = prepare(pv, pv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (tk + kBlockK - 1) / kBlockK;
  const size_t rows = static_cast<size_t>(b) * h * tq;
  float* s = work;
  float* tmax = s + rows * n_tiles * kBlockK;
  float* part = tmax + rows * n_tiles;
  const int n_blocks = (tk + kChunk - 1) / kChunk;
  const dim3 grid(b * h, n_blocks);
  scores<<<grid, kThreads, scores_smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), kv_len, s, tmax, h,
      tq, tk, n_tiles, d_total, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pv_grid(b * h, n_blocks, d_total / D);
  pv<<<pv_grid, kThreads, pv_smem, stream>>>(
      static_cast<const TK*>(v), kv_len, s, tmax, part, tickets,
      static_cast<TQ*>(o), h, tq, tk, n_tiles, d_total);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kChunked, typename TQ>
int launch_by_cache(const void* q, const void* k, const void* v,
                    const int* kv_len, void* o, float* work, int* tickets,
                    int b, int h, int tq, int tk, int d_total, int kv_dtype,
                    float scale, cudaStream_t stream) {
  if (kv_dtype == kF32) {
    return launch<D, kChunked, TQ, float>(q, k, v, kv_len, o, work, tickets,
                                          b, h, tq, tk, d_total, scale, stream);
  }
  if (kv_dtype == kBF16) {
    return launch<D, kChunked, TQ, __nv_bfloat16>(
        q, k, v, kv_len, o, work, tickets, b, h, tq, tk, d_total, scale,
        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool kChunked = false>
int launch_by_q(const void* q, const void* k, const void* v, const int* kv_len,
                void* o, float* work, int* tickets, int b, int h, int tq,
                int tk, int d_total, int q_dtype, int kv_dtype, float scale,
                cudaStream_t stream) {
  if (q_dtype == kF32) {
    return launch_by_cache<D, kChunked, float>(q, k, v, kv_len, o, work,
                                               tickets, b, h, tq, tk, d_total,
                                               kv_dtype, scale, stream);
  }
  if (q_dtype == kBF16) {
    return launch_by_cache<D, kChunked, __nv_bfloat16>(
        q, k, v, kv_len, o, work, tickets, b, h, tq, tk, d_total, kv_dtype,
        scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Workspace floats one launch needs: b * h * tq rows of ceil(tk / 32) tiles,
// each the tile's 32 scores, its max and its (alpha, sum of p, p.v[d]).
long long rtt_flash_decode_work(int b, int h, int tq, int tk, int d) {
  const long long n_tiles = (tk + kBlockK - 1) / kBlockK;
  return static_cast<long long>(b) * h * tq * n_tiles * (kWorkPerTile + d);
}

// kv_dtype: kF32 or kBF16 (the int8 cache: rtt_flash_decode_int8). `work`
// holds at least `work_floats` f32 (rtt_flash_decode_work), `tickets` b * h
// zeroed int32; k and v start on 16-byte boundaries. Two launches; returns
// cudaGetLastError() after them (0 on success). The head dims built (the
// `case`s below, ops/flash_attention.py KERNEL_HEAD_DIMS): 8, 16, 32, 64,
// 128 and 256, each for every pair of types; a multiple of kHeadChunk past
// 256 runs the chunked body. An unsupported head dim or dtype, or a
// workspace too small, returns cudaErrorInvalidValue without launching.
int rtt_flash_decode(const void* q, const void* k, const void* v,
                     const int* kv_len, void* o, void* work, void* tickets,
                     long long work_floats, int b, int h, int tq, int tk,
                     int d, int q_dtype, int kv_dtype, float scale,
                     void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 ||
      (tk + kChunk - 1) / kChunk > 65535 ||
      work_floats < rtt_flash_decode_work(b, h, tq, tk, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wf = static_cast<float*>(work);
  int* ti = static_cast<int*>(tickets);
#define RTT_DECODE(D)                                                      \
  return launch_by_q<D>(q, k, v, kv_len, o, wf, ti, b, h, tq, tk, D, q_dtype, \
                        kv_dtype, scale, s)
  switch (d) {
    case 8: RTT_DECODE(8);
    case 16: RTT_DECODE(16);
    case 32: RTT_DECODE(32);
    case 64: RTT_DECODE(64);
    case 128: RTT_DECODE(128);
    case 256: RTT_DECODE(256);
  }
#undef RTT_DECODE
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_by_q<kHeadChunk, true>(q, k, v, kv_len, o, wf, ti, b, h, tq,
                                         tk, d, q_dtype, kv_dtype, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
