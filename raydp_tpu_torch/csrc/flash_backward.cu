// Flash attention backward for Hopper (sm_90a), with a plain C interface for
// ctypes: the gradient of the training path's attention, from the saved
// normalized output's row statistics (FlashAttention-2).
//
// Replaces, in raydp_tpu/ops/flash_attention.py (flash_backward_blocks),
// for f32 q/k/v (rtt_flash_bwd_dq / rtt_flash_bwd_dkv below send bf16 to
// the tensor-core kernels of flash_backward_sm90.cu):
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel (:375), the pallas_call at :540
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel (:421), the pallas_call at :561
//
// Both take q/do [BH, T, D], k/v [BH, Tk, D] f32, the row logsumexp lse
// and dsum = rowsum(do * o) [BH, T] f32, and the blocks' global offsets for
// the causal mask. With s = scale * q.k, p = exp(s - lse) (exactly 0 where
// masked: k_pos > q_pos or past the ragged edge), dp = do.v and
// ds = p * (dp - dsum) * scale:
//   dq = sum_k ds * k,   dk = sum_q ds * q,   dv = sum_q p * do.
//
// What bounds them on an H100. For each live (query, key) pair dq
// recomputes s and dp and accumulates ds * k: 6 * D operations; dk/dv
// recompute s and dp and accumulate two products: 8 * D. At T = 2048, D =
// 128 that is hundreds of operations a byte of q, k, v, do: bound by
// operations, the FP32 pipes of the CUDA cores (67 TFLOP/s). Tensor cores
// stay out: TF32 would round the operands, and the gradients are held to
// 1e-4 of the plain version.
//
// What holds it back, and what the design does about it. The FP32 pipes
// take 128 FMAs a clock on an SM; shared memory gives 128 bytes a clock, and
// a warp's 16-byte load (LDS.128) takes four of those clocks. A thread needs
// about 4 FMAs for every float it loads from shared memory before the FP32
// pipes, not shared memory, are the limit. The first version (one warp a
// row, one key or query a lane) loaded about one float a FMA. Here a block
// owns 64 rows (query rows for dq, key rows for dk/dv) with 256 threads in
// two groups of 128, and walks 64-key (dq) or 64-query (dk/dv) tiles:
// - s and dp: one group computes s, the other dp, each as register tiles of
//   8 rows x 4 columns a thread, one __fmaf_rn chain over d ascending; per
//   4 d a thread loads 8 + 4 float4s for 128 FMAs (2.7 a float);
// - p and ds: each group hands the other half of its tile through the
//   [64][64] ds tile (dk/dv: ds^T), then each turns its half into p and ds
//   from registers and that tile, loading all its operands before its
//   first store; dk/dv writes p^T to a second tile;
// - the products as register tiles of 8 rows x 8 columns (8 x 4 at D 64):
//   per 4 of the summed index a thread loads 8 + 8 float4s for 256 FMAs (4
//   a float). dk/dv: one group accumulates dk += ds^T Q, the other dv +=
//   p^T dO, 64 accumulators a thread across the whole loop. dq: the groups
//   split the tile's keys, 32 each, and dq is their two sums added once at
//   the end, so each element is summed in a fixed order.
// Row pitches of Q, dO, K, V and the tiles are padded by 16 bytes, so that
// the 8 rows a quarter-warp reads at once fall in distinct banks. The tiles
// arrive by 16-byte cp.async copies from every thread, zero-filled past T
// or Tk. dq stages Q and dO once and double-buffers K and V: the next tile
// is in flight while this one is computed (220 KB at D 128). dk/dv stages K
// and V once and double-buffers Q; a second dO stage would not fit (K, V,
// two Q, two dO and the two [64][64] tiles are 236 KB against 227), so the
// tile's dO is copied after the previous tile is done and its latency is
// paid once a tile (204 KB at D 128). A block holds an SM alone. Under a
// causal mask dq runs the last row blocks first and dk/dv the first key
// blocks first (the ones with the most live tiles), so the card, which
// starts each next block on the SM that frees first, spreads the unequal
// work evenly; a block visits only the tiles live for some row of it and
// masks element by element only on tiles that some row does not see whole.
// Each output element is owned by one thread and summed in a fixed order,
// with no atomics, so two launches give the same bits.
//
// Head dims. D 64 and 128 are the widths above. At D 256 (bench.py's LM at
// d_model 2048, 8 heads) a block owns 32 rows (kRows) and stages the
// walked tiles once (kStages 1): dq's Q and dO (32 rows), one K and one V
// tile (64 rows) and the [32][64] ds tile are 204 KB, dk/dv's K and V (32
// rows), one Q and one dO tile and two [32][64] tiles 212 KB, where 64
// own rows and two stages would be 400 and 333 KB. A thread holds 4 own
// rows (s and dp tiles of 4 x 4, products of 4 rows x 16 columns: 64
// accumulators, as at D 128). With one stage the next tile's copies start
// when this one is done with them (dq: V after s and dp, K after ds K),
// so a tile waits for its own loads. D 8, 16 and 32 (the small
// LMs' heads) run the same bodies, as the f32 forward does at those widths:
// s and dp as before (8 x 4 register tiles over d, 2 to 8 steps of 4), and
// in the products a thread's 4 columns are 4 lo mod D, so the 16 threads of
// a row group hold D / 4 distinct column quads and the rest repeat a lower
// thread's, storing nothing (owns_cols). A block's 36 KB (dq, D 8) to 81 KB
// (dk/dv, D 32) let several share an SM. Any other D up to 256 arrives
// zero-padded by the wrapper to the next of these widths.
//
// Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512) arrive
// zero-padded by the wrapper to a multiple of kHeadChunk (256), n = D / 256
// chunks, and run flash_bwd_dq_chunked_kernel /
// flash_bwd_dkv_chunked_kernel. A block of 256 threads owns 32 rows
// (queries for dq, keys for dk/dv) and two 256-column chunks of their
// gradient (m = ceil(n / 2) blocks a row block; an odd n leaves the last
// block one chunk), so s and dp are computed once for 512 gradient
// columns: at D 512 once in all, at D 1024 and 1536 (4 m + 2) / 6 (dq)
// and (m + 1) / 2 (dk/dv) times one pass's operations. The budget that
// shapes the layout:
// - Shared memory, 227 KB a block. An f32 row at D 512 with its 16-byte pad
//   is 2064 bytes: 32 own rows of Q and dO (or K and V) are 132 KB and a
//   64-row walked tile at full width another 132 KB (264 for Q and dO). So
//   nothing is held at full width: everything streams from L2 through a
//   ring of two 99.5 KB stages, each step's copies (16-byte cp.async)
//   issued a whole step before it, behind the step before's arithmetic,
//   one barrier a step. A tile is n_pieces = D / 128 s-steps and then its
//   product steps. An s-step stages a 128-column piece of the own rows and
//   of the tile (32 + 32 + 64 + 64 rows at a 132-float pitch; the last also
//   the tile's lse and dsum for dk/dv). A product step stages rows of the
//   tile at the block's two chunks (dq: 32 keys of K, two steps a tile;
//   dk/dv: 16 queries of Q and of dO, four), so that a thread's 16 columns
//   of a chunk are all in one step. So the own rows are staged once a tile
//   (they do not fit beside the ring), and the walked tile's gradient
//   operand twice (dq: K; dk/dv: Q and dO), for s or dp and again for the
//   products: bytes from L2 in place of recomputed operations. At D 512 a
//   tile reads 512 KB (dq) and 640 KB (dk/dv), where one block a chunk
//   read 832 and 896 KB over a row block's two blocks. dq: the ring, the
//   [32][64] ds tile and the rows' lse and dsum, 208 KB; dk/dv: the ring
//   and the p^T and ds^T tiles, 216 KB. A ring of four stages of 64-column
//   pieces (more steps, each with its barrier) measured slower (PERF.md).
// - Registers. The s-steps carry each thread's 4 x 4 s or dp chains
//   through the pieces (the D 256 tiles: group 0 s, group 1 dp); a warp
//   holds 4 rows x 8 columns of them, so that each operand load is one
//   shared-memory wavefront. dq: 32 rows x 512 columns over 256 threads is
//   64 accumulators a thread, as at D 256; the two groups split the
//   columns (group g the block's chunk g), not the keys, so each dq element
//   is one chain over the keys and needs no merge. dk/dv: 32 keys x 512
//   columns of dk and of dv is 128 accumulators a thread, group 0 dk and
//   group 1 dv at both chunks; with the s^T or dp^T tile and the operands
//   ptxas fits them in 254 registers without a spill. 512 threads (four
//   groups of dk or dv at one chunk, 64 accumulators a thread) spilled
//   under the 128 registers a thread they leave and ran slower; 16 keys a
//   block would read Q and dO twice as often; the sums in 128 KB of shared
//   memory would leave no room for the ring (PERF.md).
// The chains are the D 256 body's: s and dp one __fmaf_rn chain over d
// ascending through the pieces, dk and dv one over the queries ascending,
// dq one over the keys ascending (not two halves added at the end). The
// copies are loops: the forward's chunk copies, unrolled with a pitch
// known only at run time, held their row offsets in registers and spilled.
//
// What the H100 showed (80GB HBM3, 700 W; PERF.md, timed by
// prefill_f32_turns.py). At [1,8,2048,128] f32 causal dq takes ~0.39 ms and
// dk/dv ~0.49 (the first version 1.57 and 1.86), about 2x their bounds, the
// pair under SDPA's f32 backward. A diagnostic build that read the clock
// around each phase (not kept) found the s and dp phase well above its
// FMAs' share, and the p/ds step, then done by the s group alone while the
// dp group waited, a large share of a tile; sharing that step between the
// groups took 12% (dq) and 10% (dk/dv) off. Register tiles of 8 x 8 for s
// and dp (d split between lane pairs, 4 FMAs a float) measured no faster:
// at 8 warps an SM the phases are bound by latency as much as by shared
// memory.

#include "flash_common.cuh"

namespace {

constexpr int kTile = 64;       // keys (dq) or queries (dk/dv) a staged tile
constexpr int kThreads = 256;   // two groups
constexpr int kGroupThreads = 128;

// Shared memory of a block, in floats. Rows of Q, dO, K and V at a pitch
// padded by 16 bytes; the [kRows][64] tiles likewise.
template <int D>
struct BwdLayout {
  // rows a block owns (queries for dq, keys for dk/dv), own rows a thread
  // holds, and the stages of the walked tiles (dq: K and V; dk/dv: Q)
  static constexpr int kRows = D > 128 ? 32 : 64;
  static constexpr int kRowsPerThread = kRows / 8;
  static constexpr int kStages = D > 128 ? 1 : 2;
  static constexpr int kPitch = D + 4;
  static constexpr int kTPitch = kTile + 4;
  static constexpr int kOwnArray = kRows * kPitch;  // own rows of Q, dO, K or V
  static constexpr int kArray = kTile * kPitch;     // a walked tile's rows
  static constexpr int kSquare = kRows * kTPitch;   // a [kRows][64] tile
  // dq: Q, dO, the stages of K and of V, ds, the rows' lse and dsum
  static constexpr int kDqQ = 0;
  static constexpr int kDqDO = kDqQ + kOwnArray;
  static constexpr int kDqK = kDqDO + kOwnArray;
  static constexpr int kDqV = kDqK + kStages * kArray;
  static constexpr int kDqS = kDqV + kStages * kArray;
  static constexpr int kDqLse = kDqS + kSquare;
  static constexpr int kDqDsum = kDqLse + kRows;
  static constexpr size_t kDqBytes = sizeof(float) * (kDqDsum + kRows);
  // dk/dv: K, V, the stages of Q, dO, p^T, ds^T, the tile's lse and dsum
  static constexpr int kKvK = 0;
  static constexpr int kKvV = kKvK + kOwnArray;
  static constexpr int kKvQ = kKvV + kOwnArray;
  static constexpr int kKvDO = kKvQ + kStages * kArray;
  static constexpr int kKvP = kKvDO + kArray;
  static constexpr int kKvDS = kKvP + kSquare;
  static constexpr int kKvLse = kKvDS + kSquare;
  static constexpr int kKvDsum = kKvLse + kTile;
  static constexpr size_t kKvBytes = sizeof(float) * (kKvDsum + kTile);
};

// The kernels' arguments, as rtt_flash_bwd_dq / rtt_flash_bwd_dkv give them.
struct BwdArgs {
  const float* q;     // [BH, T, D]
  const float* k;     // [BH, Tk, D]
  const float* v;
  const float* dout;  // [BH, T, D]
  const float* lse;   // [BH, T]
  const float* dsum;
  float* dq;          // [BH, T, D]
  float* dk;          // [BH, Tk, D]
  float* dv;
  int n_bh, t, tk, q_off, k_off, causal;
  float scale;
  int d_total;  // the chunked bodies' padded head dim (rows' pitch)
};

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N rows of D floats from `src` into `dst` at the padded pitch, 16 bytes a
// copy spread over the block; rows at or past `valid` are zeros.
template <int D, int N>
__device__ __forceinline__ void copy_rows(const float* src, int valid,
                                          float* dst) {
  constexpr int kPieces = D / 4;
  constexpr int kCopies = N * kPieces;  // fewer than the threads at D 8
#pragma unroll
  for (int u = 0; u < (kCopies + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) break;
    const int r = i / kPieces;
    const int c = (i % kPieces) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * BwdLayout<D>::kPitch + c, src + (ok ? r : 0) * D + c,
               ok);
  }
}

// acc[r][i] = a[8r] . b[16i], rows of D floats at the padded pitch (a and
// b point at the thread's first rows): R x 4 dot products a thread (R =
// kRowsPerThread: 8, or 4 at D 256), each one __fmaf_rn chain over d
// ascending. Per 4 d it loads R a and 4 b float4s for 16 R FMAs.
template <int D, int R>
__device__ __forceinline__ void dots_8x4(const float* a, const float* b,
                                         float (&acc)[R][4]) {
  constexpr int P = BwdLayout<D>::kPitch;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 x[R], y[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = *reinterpret_cast<const float4*>(a + 8 * r * P + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = *reinterpret_cast<const float4*>(b + 16 * i * P + c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[r][i] = __fmaf_rn(part(x[r], e), part(y[i], e), acc[r][i]);
        }
      }
    }
  }
}

// The product columns of thread lo of a row group: 4 lo + 64 c (c <
// col_chunks), or from D 32 down 4 lo mod D, which the threads past the
// row's D / 4 column quads repeat without storing (owns_cols).
template <int D>
__host__ __device__ constexpr int col_chunks() { return D >= 64 ? D / 64 : 1; }

template <int D>
__device__ __forceinline__ int first_col(int lo) {
  return D >= 64 ? 4 * lo : (4 * lo) % D;
}

template <int D>
__device__ __forceinline__ bool owns_cols(int lo) {
  return D >= 64 || 4 * lo < D;
}

// acc[r][4c + e] += sum over j < N ascending of w[8r][j] * m[j][64c + e]:
// w a [kRows][64] tile (pointing at the thread's first row), m rows of D
// floats at the padded pitch (pointing at the thread's first column).
// R rows x 4 col_chunks columns a thread; per 4 j it loads R w and 4
// col_chunks m float4s for 4 R col_chunks FMAs.
template <int D, int N, int R>
__device__ __forceinline__ void accumulate(const float* w, const float* m,
                                           float (&acc)[R][4 * col_chunks<D>()]) {
  constexpr int P = BwdLayout<D>::kPitch;
  constexpr int TP = BwdLayout<D>::kTPitch;
  constexpr int kChunks = col_chunks<D>();
#pragma unroll
  for (int jb = 0; jb < N; jb += 4) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = *reinterpret_cast<const float4*>(w + 8 * r * TP + jb);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 y[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        y[c] = *reinterpret_cast<const float4*>(m + (jb + jj) * P + 64 * c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][4 * c + e] = __fmaf_rn(part(x[r], jj), part(y[c], e),
                                          acc[r][4 * c + e]);
          }
        }
      }
    }
  }
}

// p and ds of one pair from its s (unscaled) and dp; exactly 0 where masked.
__device__ __forceinline__ void pair_grads(float s, float dp, float lse,
                                           float dsum, bool live, float scale,
                                           float& p, float& ds) {
  p = live ? expf(__fsub_rn(__fmul_rn(s, scale), lse)) : 0.f;
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dsum)), scale);
}

// Each group hands the other the half of its s (group 0) or dp (group 1)
// tile that the other turns into p and ds, through `tile`: group 0 takes
// the thread's columns i < 2, group 1 those of i >= 2.
template <int R>
__device__ __forceinline__ void hand_over(const float (&sd)[R][4], float* tile,
                                          int group, int hi, int lo) {
  constexpr int TP = kTile + 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = j + 2 * (1 - group);
      tile[(hi + 8 * r) * TP + lo + 16 * i] = group ? sd[r][j] : sd[r][j + 2];
    }
  }
}

// dq: p and ds of the thread's half of the tile of keys [kt0, kt0 + 64)
// against rows [row0, row0 + kRows), from its own s or dp and the other
// group's half in the ds tile, where ds goes (all operands loaded before
// the first store).
template <int kRows, int R>
__device__ __forceinline__ void dq_tile_grads(const BwdArgs& a,
                                              const float (&sd)[R][4],
                                              float* ds, const float* lse_s,
                                              const float* dsum_s, int group,
                                              int hi, int lo, int row0,
                                              int rows, int kt0) {
  constexpr int TP = kTile + 4;
  const bool full = rows == kRows && kt0 + kTile <= a.tk &&
      (!a.causal || a.q_off + row0 >= a.k_off + kt0 + kTile - 1);
  float other[R][2];  // dp (group 0) or s (group 1), loaded before any store
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      other[r][j] = ds[(hi + 8 * r) * TP + lo + 16 * (j + 2 * group)];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = hi + 8 * r;
    const int q_pos = a.q_off + row0 + row;
    const float lse = lse_s[row];
    const float dsum = dsum_s[row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = lo + 16 * (j + 2 * group);
      const int key = kt0 + col;
      const bool live = full || (row < rows && key < a.tk &&
                                 (!a.causal || q_pos >= a.k_off + key));
      const float mine = group ? sd[r][j + 2] : sd[r][j];
      float p;
      pair_grads(group ? other[r][j] : mine, group ? mine : other[r][j],
                 lse, dsum, live, a.scale, p, ds[row * TP + col]);
    }
  }
}

// dk/dv: the first q-tile of 64 with a query at or after key0 under a
// causal mask (0 without one).
__device__ __forceinline__ int first_live_qtile(const BwdArgs& a, int key0,
                                                int n_qtiles) {
  if (!a.causal) return 0;
  const int q_start = a.k_off + key0 - a.q_off;
  return q_start <= 0 ? 0 : min(n_qtiles, q_start / kTile);
}

// dk/dv: p^T and ds^T of the thread's half of the tile of queries [qt0,
// qt0 + 64) against keys [key0, key0 + kRows), from its own s^T or dp^T
// and the other group's half in the ds^T tile, into pt and dst (all
// operands loaded before the first store).
template <int kRows, int R>
__device__ __forceinline__ void dkv_tile_grads(const BwdArgs& a,
                                               const float (&sd)[R][4],
                                               float* pt, float* dst,
                                               const float* lse_s,
                                               const float* dsum_s, int group,
                                               int hi, int lo, int key0,
                                               int keys, int qt0) {
  constexpr int TP = kTile + 4;
  const bool full = keys == kRows && qt0 + kTile <= a.t &&
      (!a.causal || a.q_off + qt0 >= a.k_off + key0 + kRows - 1);
  float other[R][2];  // dp (group 0) or s (group 1), loaded before any store
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      other[r][j] = dst[(hi + 8 * r) * TP + lo + 16 * (j + 2 * group)];
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qq = lo + 16 * (j + 2 * group);
    const int q_pos = a.q_off + qt0 + qq;
    const float lse = lse_s[qq];
    const float dsum = dsum_s[qq];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = hi + 8 * r;
      const bool live = full || (qt0 + qq < a.t && key < keys &&
                                 (!a.causal || q_pos >= a.k_off + key0 + key));
      const float mine = group ? sd[r][j + 2] : sd[r][j];
      const int e = key * TP + qq;
      pair_grads(group ? other[r][j] : mine, group ? mine : other[r][j],
                 lse, dsum, live, a.scale, pt[e], dst[e]);
    }
  }
}

// dq of rows [row0, row0 + kRows) of one bh: Q and dO staged once, then
// every 64-key tile live for some row of the block, the next one in flight
// (two stages) or loaded as this one frees its stage (one). Threads: group
// 0 computes s and then the first 32 keys of each tile's ds K, group 1 dp
// and then the last 32; thread (hi, lo) of a group holds rows hi + 8r and
// keys lo + 16i of s or dp, then rows hi + 8r and columns 4 lo + 64c of dq.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const BwdArgs a) {
  using L = BwdLayout<D>;
  constexpr int P = L::kPitch;
  constexpr int TP = L::kTPitch;
  constexpr int kRows = L::kRows;
  constexpr int R = L::kRowsPerThread;
  extern __shared__ __align__(16) float smem[];
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const size_t bh = blockIdx.x % a.n_bh;
  const int row0 =
      (n_row_blocks - 1 - static_cast<int>(blockIdx.x / a.n_bh)) * kRows;
  const int rows = min(kRows, a.t - row0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  const int n_tiles = (k_end + kTile - 1) / kTile;

  const int group = threadIdx.x / kGroupThreads;
  const int lo = threadIdx.x % 16;
  const int hi = (threadIdx.x % kGroupThreads) / 16;
  float* qs = smem + L::kDqQ;
  float* dos = smem + L::kDqDO;
  float* ds = smem + L::kDqS;
  const float* lse_s = smem + L::kDqLse;
  const float* dsum_s = smem + L::kDqDsum;
  if (threadIdx.x < kRows) {
    const bool ok = static_cast<int>(threadIdx.x) < rows;
    smem[L::kDqLse + threadIdx.x] = ok ? a.lse[qbase + row0 + threadIdx.x] : 0.f;
    smem[L::kDqDsum + threadIdx.x] =
        ok ? a.dsum[qbase + row0 + threadIdx.x] : 0.f;
  }

  constexpr int kAcc = 4 * col_chunks<D>();
  float acc[R][kAcc];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[r][c] = 0.f;
  }
  if (n_tiles > 0) {
    copy_rows<D, kRows>(a.q + (qbase + row0) * D, rows, qs);
    copy_rows<D, kRows>(a.dout + (qbase + row0) * D, rows, dos);
    copy_rows<D, kTile>(a.k + kbase * D, a.tk, smem + L::kDqK);
    copy_rows<D, kTile>(a.v + kbase * D, a.tk, smem + L::kDqV);
    commit_copies();
  }
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int kt0 = ti * kTile;
    const int next = kt0 + kTile;
    const bool more = ti + 1 < n_tiles;
    const int stage = L::kStages == 2 ? ti & 1 : 0;
    const float* kt = smem + L::kDqK + stage * L::kArray;
    const float* vt = smem + L::kDqV + stage * L::kArray;
    if (L::kStages == 2 && more) {  // into the stage the last tile freed
      copy_rows<D, kTile>(a.k + (kbase + next) * D, a.tk - next,
                          smem + L::kDqK + (stage ^ 1) * L::kArray);
      copy_rows<D, kTile>(a.v + (kbase + next) * D, a.tk - next,
                          smem + L::kDqV + (stage ^ 1) * L::kArray);
      commit_copies();
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();  // this tile's K and V are in (and Q, dO, lse, dsum)

    float sd[R][4];  // s (group 0) or dp (group 1)
    dots_8x4<D, R>((group ? dos : qs) + hi * P, (group ? vt : kt) + lo * P,
                   sd);
    // p and ds: each group first hands the other its half through the ds tile
    hand_over(sd, ds, group, hi, lo);
    __syncthreads();  // the halves are in
    if (L::kStages == 1 && more) {  // V is free: the next tile's
      copy_rows<D, kTile>(a.v + (kbase + next) * D, a.tk - next,
                          smem + L::kDqV);
      commit_copies();
    }
    dq_tile_grads<kRows>(a, sd, ds, lse_s, dsum_s, group, hi, lo, row0, rows,
                         kt0);
    __syncthreads();  // ds is in
    constexpr int kHalfTile = kTile / 2;
    accumulate<D, kHalfTile, R>(ds + hi * TP + group * kHalfTile,
                                kt + group * kHalfTile * P + first_col<D>(lo),
                                acc);
    __syncthreads();  // this tile's K, V and ds are free
    if (L::kStages == 1 && more) {
      copy_rows<D, kTile>(a.k + (kbase + next) * D, a.tk - next,
                          smem + L::kDqK);
      commit_copies();
    }
  }

  // dq = group 0's sum over the first 32 keys of each tile + group 1's
  // over the last 32; group 1's sums pass through the free K stage.
  float* other = smem + L::kDqK;
  const bool owns = owns_cols<D>(lo);
  if (group == 1 && owns) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < col_chunks<D>(); ++c) {
        *reinterpret_cast<float4*>(other + (hi + 8 * r) * D + 4 * lo + 64 * c) =
            make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                        acc[r][4 * c + 3]);
      }
    }
  }
  __syncthreads();
  if (group == 1 || !owns) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = hi + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < col_chunks<D>(); ++c) {
      const int col = 4 * lo + 64 * c;
      const float4 o = *reinterpret_cast<const float4*>(other + row * D + col);
      *reinterpret_cast<float4*>(a.dq + (qbase + row0 + row) * D + col) =
          make_float4(__fadd_rn(acc[r][4 * c], o.x),
                      __fadd_rn(acc[r][4 * c + 1], o.y),
                      __fadd_rn(acc[r][4 * c + 2], o.z),
                      __fadd_rn(acc[r][4 * c + 3], o.w));
    }
  }
}

// dk and dv of key rows [key0, key0 + kRows) of one bh: K and V staged
// once, then every 64-query tile live for some key of the block, the next
// tile's Q in flight (two stages; with one, each tile's Q and dO load
// together). Threads: group 0 computes s^T, p^T and ds^T and then dk +=
// ds^T Q, group 1 dp^T and then dv += p^T dO; thread (hi, lo) of a group
// holds keys hi + 8r and queries lo + 16i of s^T or dp^T, then keys hi + 8r
// and columns 4 lo + 64c of dk or dv.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const BwdArgs a) {
  using L = BwdLayout<D>;
  constexpr int P = L::kPitch;
  constexpr int TP = L::kTPitch;
  constexpr int kRows = L::kRows;
  constexpr int R = L::kRowsPerThread;
  extern __shared__ __align__(16) float smem[];
  const size_t bh = blockIdx.x % a.n_bh;
  const int key0 = static_cast<int>(blockIdx.x / a.n_bh) * kRows;
  const int keys = min(kRows, a.tk - key0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  const int n_qtiles = (a.t + kTile - 1) / kTile;
  const int first = first_live_qtile(a, key0, n_qtiles);

  const int group = threadIdx.x / kGroupThreads;
  const int lo = threadIdx.x % 16;
  const int hi = (threadIdx.x % kGroupThreads) / 16;
  const float* ks = smem + L::kKvK;
  const float* vs = smem + L::kKvV;
  float* dos = smem + L::kKvDO;
  float* pt = smem + L::kKvP;
  float* dst = smem + L::kKvDS;
  float* lse_s = smem + L::kKvLse;
  float* dsum_s = smem + L::kKvDsum;

  // threads < 64 carry the next tile's lse and dsum, one query each, until
  // the tile before it is done with its own
  float lse_r = 0.f;
  float dsum_r = 0.f;
  auto load_stats = [&](int qt0) {
    if (threadIdx.x < kTile) {
      const int qi = qt0 + static_cast<int>(threadIdx.x);
      lse_r = qi < a.t ? a.lse[qbase + qi] : 0.f;
      dsum_r = qi < a.t ? a.dsum[qbase + qi] : 0.f;
    }
  };

  constexpr int kAcc = 4 * col_chunks<D>();
  float acc[R][kAcc];  // dk (group 0) or dv (group 1)
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[r][c] = 0.f;
  }
  if (first < n_qtiles) {
    const int qt0 = first * kTile;
    copy_rows<D, kRows>(a.k + (kbase + key0) * D, keys, smem + L::kKvK);
    copy_rows<D, kRows>(a.v + (kbase + key0) * D, keys, smem + L::kKvV);
    copy_rows<D, kTile>(a.q + (qbase + qt0) * D, a.t - qt0, smem + L::kKvQ);
    commit_copies();
    load_stats(qt0);
  }
  for (int qi = first; qi < n_qtiles; ++qi) {
    const int qt0 = qi * kTile;
    const int next = qt0 + kTile;
    const bool more = qi + 1 < n_qtiles;
    const int stage = L::kStages == 2 ? (qi - first) & 1 : 0;
    const float* qt = smem + L::kKvQ + stage * L::kArray;
    if (L::kStages == 1 && qi > first) {  // into the stage the last tile freed
      copy_rows<D, kTile>(a.q + (qbase + qt0) * D, a.t - qt0, smem + L::kKvQ);
    }
    copy_rows<D, kTile>(a.dout + (qbase + qt0) * D, a.t - qt0, dos);
    commit_copies();
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_r;
      dsum_s[threadIdx.x] = dsum_r;
    }
    if (L::kStages == 2 && more) {  // into the stage the last tile freed
      copy_rows<D, kTile>(a.q + (qbase + next) * D, a.t - next,
                          smem + L::kKvQ + (stage ^ 1) * L::kArray);
      commit_copies();
      load_stats(next);
      wait_copies<1>();
    } else {
      if (more) load_stats(next);
      wait_copies<0>();
    }
    __syncthreads();  // this tile's Q, dO, lse and dsum are in (and K, V)

    float sd[R][4];  // s^T (group 0) or dp^T (group 1)
    dots_8x4<D, R>((group ? vs : ks) + hi * P, (group ? dos : qt) + lo * P,
                   sd);
    // p and ds: each group first hands the other its half through the ds^T
    // tile
    hand_over(sd, dst, group, hi, lo);
    __syncthreads();  // the halves are in
    dkv_tile_grads<kRows>(a, sd, pt, dst, lse_s, dsum_s, group, hi, lo, key0,
                          keys, qt0);
    __syncthreads();  // p^T and ds^T are in
    accumulate<D, kTile, R>((group ? pt : dst) + hi * TP,
                            (group ? dos : qt) + first_col<D>(lo), acc);
    __syncthreads();  // this tile's Q, dO, p^T and ds^T are free
  }

  float* out = group ? a.dv : a.dk;
  if (!owns_cols<D>(lo)) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = hi + 8 * r;
    if (key >= keys) continue;
#pragma unroll
    for (int c = 0; c < col_chunks<D>(); ++c) {
      *reinterpret_cast<float4*>(out + (kbase + key0 + key) * D + 4 * lo +
                                 64 * c) =
          make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                      acc[r][4 * c + 3]);
    }
  }
}

// The chunked bodies (head dims past 256, d_total = n * kHeadChunk; the
// header's "Head dims past 256"): a block of 256 threads owns 32 rows and
// the gradient's chunks own0 and own0 + 1 (one, at the end of an odd n).
// Each walked tile runs n_pieces s-steps and then its product steps
// through a ring of two stages: step f is read from stage f & 1 while step
// f + 1's copies fill the other.
constexpr int kPiece = 128;              // columns an s-step stages
constexpr int kPiecePitch = kPiece + 4;  // floats, padded by 16 bytes
constexpr int kChunkPitch = kHeadChunk + 4;
constexpr int kOwnRows = 32;             // rows a chunked block owns
constexpr int kDqStepKeys = 32;          // keys of K a dq product step
constexpr int kKvStepQueries = 16;       // queries of Q and dO a dk/dv one
// A ring stage, in floats: an s-step's piece of 32 + 32 own rows and 64 +
// 64 tile rows, then (dk/dv, the tile's last s-step) the tile's lse and
// dsum; or a product step's rows at the block's two chunks.
constexpr int kStageRows = (2 * kOwnRows + 2 * kTile) * kPiecePitch;
constexpr int kStage = kStageRows + 2 * kTile;
static_assert(2 * kDqStepKeys * kChunkPitch <= kStage &&
                  4 * kKvStepQueries * kChunkPitch <= kStage,
              "a product step fits a stage");

struct ChunkedLayout {
  static constexpr int kSquare = kOwnRows * (kTile + 4);  // a [32][64] tile
  // dq: the ring, ds, the rows' lse and dsum
  static constexpr int kDqDS = 2 * kStage;
  static constexpr int kDqLse = kDqDS + kSquare;
  static constexpr int kDqDsum = kDqLse + kOwnRows;
  static constexpr size_t kDqBytes = sizeof(float) * (kDqDsum + kOwnRows);
  // dk/dv: the ring, p^T, ds^T
  static constexpr int kKvP = 2 * kStage;
  static constexpr int kKvDS = kKvP + kSquare;
  static constexpr size_t kKvBytes = sizeof(float) * (kKvDS + kSquare);
};
static_assert(ChunkedLayout::kDqBytes <= 232448 &&
                  ChunkedLayout::kKvBytes <= 232448,
              "a block's shared memory");

// N rows of kCols floats from `src`, rows `src_pitch` floats apart, into
// `dst` at kDstPitch, 16 bytes a copy spread over the block; rows at or
// past `valid` are zeros (src must still point at a row of the tensor).
// It stays a loop: the forward's chunk copies, unrolled with a pitch known
// only at run time, held their row offsets in registers and spilled.
template <int N, int kCols, int kDstPitch>
__device__ __forceinline__ void copy_slab(const float* src, int src_pitch,
                                          int valid, float* dst) {
  constexpr int kPieces = kCols / 4;         // 16-byte copies a row
  constexpr int kRound = kThreads / kPieces;  // rows a round of copies covers
  static_assert(kThreads % kPieces == 0 && N % kRound == 0, "whole rounds");
  const int c = (threadIdx.x % kPieces) * 4;
  dst += threadIdx.x / kPieces * kDstPitch + c;
#pragma unroll 1
  for (int r = threadIdx.x / kPieces; r < N; r += kRound) {
    const bool ok = r < valid;
    cp_async16(dst, src + static_cast<size_t>(ok ? r : 0) * src_pitch + c, ok);
    dst += kRound * kDstPitch;
  }
}

// One float from `src` into `dst` (a zero where !ok, reading nothing), in
// the thread's current copy group.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// acc[r][i] += a[8 r] . b[16 i] over one piece (kPiece columns at the
// piece pitch; a and b point at the thread's first rows): 4 x 4 chains a
// thread, each carried on from the last piece with one __fmaf_rn a d
// ascending, as dots_8x4 at D 256. Per 4 d a thread loads 4 + 4 float4s
// for 64 FMAs, each b float4 used as it arrives.
__device__ __forceinline__ void piece_dots(const float* a, const float* b,
                                           float (&acc)[4][4]) {
#pragma unroll
  for (int c = 0; c < kPiece; c += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = *reinterpret_cast<const float4*>(a + 8 * r * kPiecePitch + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 y =
          *reinterpret_cast<const float4*>(b + 16 * i * kPiecePitch + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][i] = __fmaf_rn(part(x[r], e), part(y, e), acc[r][i]);
        }
      }
    }
  }
}

// acc[r][4c + e] += sum over j < N ascending of w[8r][j] * m[j][64c + e]:
// accumulate's products at D 256 for a chunk's rows at the chunk pitch (w
// a [32][64] tile at the thread's first row, m at its first column), each
// m float4 used as it arrives.
template <int N>
__device__ __forceinline__ void chunk_accumulate(const float* w,
                                                 const float* m,
                                                 float (&acc)[4][16]) {
  constexpr int TP = kTile + 4;
#pragma unroll
  for (int jb = 0; jb < N; jb += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = *reinterpret_cast<const float4*>(w + 8 * r * TP + jb);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(
            m + (jb + jj) * kChunkPitch + 64 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][4 * c + e] =
                __fmaf_rn(part(x[r], jj), part(y, e), acc[r][4 * c + e]);
          }
        }
      }
    }
  }
}

// A thread's place in a group of 128 in the chunked bodies: rows (or keys)
// hi + 8r and, in the s-steps, columns (keys or queries) lo + 16i, in the
// products columns 4 lo + 64c of its chunk. A warp holds 4 his x 8 los, so
// that each load of a row operand and of a column operand is one
// shared-memory wavefront (16 los of 2 his took two for the column one).
__device__ __forceinline__ void chunked_place(int& hi, int& lo) {
  const int warp = threadIdx.x % kGroupThreads / 32;
  hi = 4 * (warp % 2) + threadIdx.x % 32 / 8;
  lo = 8 * (warp / 2) + threadIdx.x % 8;
}

// dq of rows [row0, row0 + 32) of one bh at the gradient's chunks own0 and
// own0 + 1 (n_own of them): block x takes row block n_row_blocks - 1 - x /
// (n_bh m), then bh x % n_bh and chunk pair (x % (n_bh m)) / n_bh (the
// longest rows first). In the s-steps group 0 carries s, group 1 dp (rows
// hi + 8r, keys lo + 16i); p and ds as at D 256; in the product steps group
// g accumulates dq += ds K at chunk own0 + g.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_chunked_kernel(const BwdArgs a) {
  using L = ChunkedLayout;
  constexpr int TP = kTile + 4;
  constexpr int PP = kPiecePitch;
  constexpr int kRows = kOwnRows;
  constexpr int kSteps = kTile / kDqStepKeys;  // product steps a tile
  extern __shared__ __align__(16) float smem[];
  const int dt = a.d_total;
  const int n_dc = dt / kHeadChunk;
  const int n_pieces = dt / kPiece;
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const int per_row_block = a.n_bh * ((n_dc + 1) / 2);
  const int rest = static_cast<int>(blockIdx.x % per_row_block);
  const int bh = rest % a.n_bh;
  const int own0 = 2 * (rest / a.n_bh);  // the block's first chunk
  const int n_own = min(2, n_dc - own0);
  const int row0 =
      (n_row_blocks - 1 - static_cast<int>(blockIdx.x / per_row_block)) * kRows;
  const int rows = min(kRows, a.t - row0);
  const int qbase = bh * a.t;  // rows of q, do, lse and dsum before the bh's
  const int kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  const int per_tile = n_pieces + kSteps;
  const int n_steps = (k_end + kTile - 1) / kTile * per_tile;

  const int group = threadIdx.x / kGroupThreads;
  int hi, lo;
  chunked_place(hi, lo);
  float* ds = smem + L::kDqDS;
  const float* lse_s = smem + L::kDqLse;
  const float* dsum_s = smem + L::kDqDsum;
  if (threadIdx.x < kRows) {
    const bool ok = static_cast<int>(threadIdx.x) < rows;
    smem[L::kDqLse + threadIdx.x] = ok ? a.lse[qbase + row0 + threadIdx.x] : 0.f;
    smem[L::kDqDsum + threadIdx.x] =
        ok ? a.dsum[qbase + row0 + threadIdx.x] : 0.f;
  }

  // step f's copies into its stage: an s-step's piece of Q and dO (the
  // block's rows) and of K and V (the tile's keys), or a product step's
  // keys of K at the block's chunks
  auto issue = [&](int f) {
    float* st = smem + (f & 1) * kStage;
    const int kt0 = f / per_tile * kTile;
    const int s = f % per_tile;
    if (s < n_pieces) {
      const int c0 = s * kPiece;
      const size_t qrow = static_cast<size_t>(qbase + row0) * dt + c0;
      const size_t krow = static_cast<size_t>(kbase + kt0) * dt + c0;
      copy_slab<kRows, kPiece, PP>(a.q + qrow, dt, rows, st);
      copy_slab<kRows, kPiece, PP>(a.dout + qrow, dt, rows, st + kRows * PP);
      copy_slab<kTile, kPiece, PP>(a.k + krow, dt, a.tk - kt0,
                                   st + 2 * kRows * PP);
      copy_slab<kTile, kPiece, PP>(a.v + krow, dt, a.tk - kt0,
                                   st + (2 * kRows + kTile) * PP);
    } else {
      const int k0 = kt0 + (s - n_pieces) * kDqStepKeys;
      const float* src =
          a.k + static_cast<size_t>(kbase + (k0 < a.tk ? k0 : kt0)) * dt +
          own0 * kHeadChunk;
#pragma unroll 1
      for (int h = 0; h < n_own; ++h) {
        copy_slab<kDqStepKeys, kHeadChunk, kChunkPitch>(
            src + h * kHeadChunk, dt, a.tk - k0,
            st + h * kDqStepKeys * kChunkPitch);
      }
    }
  };

  float acc[4][16];
  float sd[4][4];  // s (group 0) or dp (group 1), one chain over the pieces
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sd[r][i] = 0.f;
  }
  if (n_steps > 0) issue(0);
  commit_copies();
  for (int f = 0; f < n_steps; ++f) {
    wait_copies<0>();
    __syncthreads();  // step f's stage is in (and lse, dsum); f - 1's is read
    if (f + 1 < n_steps) issue(f + 1);
    commit_copies();
    const float* st = smem + (f & 1) * kStage;
    const int s = f % per_tile;
    if (s < n_pieces) {
      if (s == 0) {  // a new tile's s or dp
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sd[r][i] = 0.f;
        }
      }
      piece_dots(st + ((group ? kRows : 0) + hi) * PP,
                 st + (2 * kRows + (group ? kTile : 0) + lo) * PP, sd);
      if (s == n_pieces - 1) {  // p and ds: each group hands the other half
        hand_over(sd, ds, group, hi, lo);
        __syncthreads();  // the halves are in
        dq_tile_grads<kRows>(a, sd, ds, lse_s, dsum_s, group, hi, lo, row0,
                             rows, f / per_tile * kTile);
      }
    } else if (group < n_own) {  // dq += ds K over the step's keys
      chunk_accumulate<kDqStepKeys>(
          ds + hi * TP + (s - n_pieces) * kDqStepKeys,
          st + group * kDqStepKeys * kChunkPitch + 4 * lo, acc);
    }
  }

  if (group >= n_own) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = hi + 8 * r;
    if (row >= rows) continue;
    float* out = a.dq + static_cast<size_t>(qbase + row0 + row) * dt +
                 (own0 + group) * kHeadChunk + 4 * lo;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(out + 64 * c) =
          make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                      acc[r][4 * c + 3]);
    }
  }
}

// dk and dv of key rows [key0, key0 + 32) of one bh at the gradient's
// chunks own0 and own0 + 1 (n_own of them): block x takes key block x /
// (n_bh m) (the first, most causal, first), then bh x % n_bh and chunk pair
// (x % (n_bh m)) / n_bh. In the s-steps group 0 carries s^T, group 1 dp^T
// (keys hi + 8r, queries lo + 16i); p^T and ds^T as at D 256; in the
// product steps group 0 accumulates dk += ds^T Q, group 1 dv += p^T dO, at
// both chunks: 128 accumulators a thread.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_chunked_kernel(const BwdArgs a) {
  using L = ChunkedLayout;
  constexpr int TP = kTile + 4;
  constexpr int PP = kPiecePitch;
  constexpr int kRows = kOwnRows;
  constexpr int kSteps = kTile / kKvStepQueries;  // product steps a tile
  constexpr int kSlab = kKvStepQueries * kChunkPitch;
  extern __shared__ __align__(16) float smem[];
  const int dt = a.d_total;
  const int n_dc = dt / kHeadChunk;
  const int n_pieces = dt / kPiece;
  const int per_key_block = a.n_bh * ((n_dc + 1) / 2);
  const int rest = static_cast<int>(blockIdx.x % per_key_block);
  const int bh = rest % a.n_bh;
  const int own0 = 2 * (rest / a.n_bh);  // the block's first chunk
  const int n_own = min(2, n_dc - own0);
  const int key0 = static_cast<int>(blockIdx.x / per_key_block) * kRows;
  const int keys = min(kRows, a.tk - key0);
  const int qbase = bh * a.t;  // rows of q, do, lse and dsum before the bh's
  const int kbase = bh * a.tk;
  const int n_qtiles = (a.t + kTile - 1) / kTile;
  const int first = first_live_qtile(a, key0, n_qtiles);
  const int per_tile = n_pieces + kSteps;
  const int n_steps = (n_qtiles - first) * per_tile;

  const int group = threadIdx.x / kGroupThreads;
  int hi, lo;
  chunked_place(hi, lo);
  float* pt = smem + L::kKvP;
  float* dst = smem + L::kKvDS;

  // step f's copies into its stage: an s-step's piece of K and V (the
  // block's keys) and of Q and dO (the tile's queries), with the tile's lse
  // and dsum at its last, or a product step's queries of Q and of dO at the
  // block's chunks (Q's chunks, then dO's)
  auto issue = [&](int f) {
    float* st = smem + (f & 1) * kStage;
    const int qt0 = (first + f / per_tile) * kTile;
    const int s = f % per_tile;
    if (s < n_pieces) {
      const int c0 = s * kPiece;
      const size_t krow = static_cast<size_t>(kbase + key0) * dt + c0;
      const size_t qrow = static_cast<size_t>(qbase + qt0) * dt + c0;
      copy_slab<kRows, kPiece, PP>(a.k + krow, dt, keys, st);
      copy_slab<kRows, kPiece, PP>(a.v + krow, dt, keys, st + kRows * PP);
      copy_slab<kTile, kPiece, PP>(a.q + qrow, dt, a.t - qt0,
                                   st + 2 * kRows * PP);
      copy_slab<kTile, kPiece, PP>(a.dout + qrow, dt, a.t - qt0,
                                   st + (2 * kRows + kTile) * PP);
      if (s == n_pieces - 1 && threadIdx.x < 2 * kTile) {
        const int qi = qt0 + static_cast<int>(threadIdx.x) % kTile;
        const bool ok = qi < a.t;
        cp_async4(st + kStageRows + threadIdx.x,
                  (threadIdx.x < kTile ? a.lse : a.dsum) + qbase +
                      (ok ? qi : qt0),
                  ok);
      }
    } else {
      const int q0 = qt0 + (s - n_pieces) * kKvStepQueries;
      const size_t row = static_cast<size_t>(qbase + (q0 < a.t ? q0 : qt0)) *
                         dt;
#pragma unroll 1
      for (int h = 0; h < n_own; ++h) {
        const size_t col = row + static_cast<size_t>(own0 + h) * kHeadChunk;
        copy_slab<kKvStepQueries, kHeadChunk, kChunkPitch>(
            a.q + col, dt, a.t - q0, st + h * kSlab);
        copy_slab<kKvStepQueries, kHeadChunk, kChunkPitch>(
            a.dout + col, dt, a.t - q0, st + (2 + h) * kSlab);
      }
    }
  };

  float acc[2][4][16];  // dk (group 0) or dv (group 1) at the two chunks
  float sd[4][4];  // s^T (group 0) or dp^T (group 1), one chain over pieces
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[0][r][c] = acc[1][r][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sd[r][i] = 0.f;
  }
  if (n_steps > 0) issue(0);
  commit_copies();
  for (int f = 0; f < n_steps; ++f) {
    wait_copies<0>();
    __syncthreads();  // step f's stage is in; step f - 1's is read
    if (f + 1 < n_steps) issue(f + 1);
    commit_copies();
    const float* st = smem + (f & 1) * kStage;
    const int s = f % per_tile;
    if (s < n_pieces) {
      if (s == 0) {  // a new tile's s^T or dp^T
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sd[r][i] = 0.f;
        }
      }
      piece_dots(st + ((group ? kRows : 0) + hi) * PP,
                 st + (2 * kRows + (group ? kTile : 0) + lo) * PP, sd);
      if (s == n_pieces - 1) {  // p^T and ds^T: each group hands the other half
        hand_over(sd, dst, group, hi, lo);
        __syncthreads();  // the halves are in
        dkv_tile_grads<kRows>(a, sd, pt, dst, st + kStageRows,
                              st + kStageRows + kTile, group, hi, lo, key0,
                              keys, (first + f / per_tile) * kTile);
      }
    } else {  // dk or dv over the step's queries, chunk by chunk
      const float* w =
          (group ? pt : dst) + hi * TP + (s - n_pieces) * kKvStepQueries;
      const float* m = st + 2 * group * kSlab + 4 * lo;
      chunk_accumulate<kKvStepQueries>(w, m, acc[0]);
      if (n_own > 1) chunk_accumulate<kKvStepQueries>(w, m + kSlab, acc[1]);
    }
  }

  float* out = group ? a.dv : a.dk;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = hi + 8 * r;
    if (key >= keys) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= n_own) break;
      float* o = out + static_cast<size_t>(kbase + key0 + key) * dt +
                 (own0 + h) * kHeadChunk + 4 * lo;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(o + 64 * c) =
            make_float4(acc[h][r][4 * c], acc[h][r][4 * c + 1],
                        acc[h][r][4 * c + 2], acc[h][r][4 * c + 3]);
      }
    }
  }
}

// One launch of either kernel: a block per (bh, kRows rows), an SM each.
template <int D>
int launch_bwd(bool dkv, const BwdArgs& args, cudaStream_t stream) {
  using L = BwdLayout<D>;
  constexpr int kRows = L::kRows;
  // one block an SM from D 64: more than half of an H100 SM's 228 KB
  static_assert(D < 64 || (L::kDqBytes > 116 * 1024 && L::kKvBytes > 116 * 1024),
                "a second block would fit an SM");
  const size_t smem = dkv ? L::kKvBytes : L::kDqBytes;
  auto kernel = dkv ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(((dkv ? args.tk : args.t) + kRows - 1) / kRows) *
      args.n_bh;
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// One launch of either chunked body (args.d_total a multiple of kHeadChunk
// past it): a block per (bh, 32 rows, two 256-column chunks), an SM each.
int launch_bwd_chunked(bool dkv, const BwdArgs& args, cudaStream_t stream) {
  using L = ChunkedLayout;
  const size_t smem = dkv ? L::kKvBytes : L::kDqBytes;
  auto kernel = dkv ? flash_bwd_dkv_chunked_kernel : flash_bwd_dq_chunked_kernel;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(((dkv ? args.tk : args.t) + kOwnRows - 1) /
                             kOwnRows) *
      args.n_bh * ((args.d_total / kHeadChunk + 1) / 2);
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 backward on tensor cores (flash_backward_sm90.cu).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, int bh, int t, int tk, int d, int q_off,
                      int k_off, int causal, float scale, cudaStream_t stream);
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dsum,
                       void* dk, void* dv, int bh, int t, int tk, int d,
                       int q_off, int k_off, int causal, float scale,
                       cudaStream_t stream);

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success); an
// unsupported head dim or dtype returns cudaErrorInvalidValue without
// launching. The head dims built (the `case`s below,
// ops/flash_attention.py KERNEL_HEAD_DIMS): 8, 16, 32, 64, 128 and 256; a
// multiple of kHeadChunk past 256 runs the chunked bodies. bf16
// goes to the tensor-core kernels, f32 to the kernels here, which copy q,
// k, v and do 16 bytes at a time: their bases must be 16-byte aligned.
int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dsum,
                     void* dq, int bh, int t, int tk, int d, int dtype,
                     int q_off, int k_off, int causal, float scale,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return flash_bwd_dq_sm90(q, k, v, dout, lse, dsum, dq, bh, t, tk, d,
                             q_off, k_off, causal, scale, s);
  }
  const BwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout), lse, dsum,
                     static_cast<float*>(dq), nullptr, nullptr, bh, t, tk,
                     q_off, k_off, causal, scale, d};
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return launch_bwd<8>(false, args, s);
    case 16: return launch_bwd<16>(false, args, s);
    case 32: return launch_bwd<32>(false, args, s);
    case 64: return launch_bwd<64>(false, args, s);
    case 128: return launch_bwd<128>(false, args, s);
    case 256: return launch_bwd<256>(false, args, s);
  }
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_bwd_chunked(false, args, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dk, void* dv, int bh, int t, int tk, int d,
                      int dtype, int q_off, int k_off, int causal, float scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return flash_bwd_dkv_sm90(q, k, v, dout, lse, dsum, dk, dv, bh, t, tk, d,
                              q_off, k_off, causal, scale, s);
  }
  const BwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dout), lse, dsum, nullptr,
                     static_cast<float*>(dk), static_cast<float*>(dv), bh, t,
                     tk, q_off, k_off, causal, scale, d};
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 8: return launch_bwd<8>(true, args, s);
    case 16: return launch_bwd<16>(true, args, s);
    case 32: return launch_bwd<32>(true, args, s);
    case 64: return launch_bwd<64>(true, args, s);
    case 128: return launch_bwd<128>(true, args, s);
    case 256: return launch_bwd<256>(true, args, s);
  }
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_bwd_chunked(true, args, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
