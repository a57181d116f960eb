// Flash attention for Hopper (sm_90a): the f32 prefill forward, with a
// plain C interface for ctypes. rtt_flash_fwd sends bf16 q/k/v to the
// tensor-core forward in flash_forward_sm90.cu and f32 to flash_fwd_kernel
// here. The f32/bf16-cache decode is flash_decode.cu, the int8-cache decode
// flash_decode_int8.cu.
//
// Replaces, in raydp_tpu/ops/flash_attention.py (pallas_call at :305, in
// _flash_call: flash_attention / flash_attention_stats), for f32 q/k/v:
//   flash_fwd          <- _flash_kernel_onepass (:146)
//   flash_fwd_twoterm  <- _flash_kernel (:83), the same call with
//                         onepass=False (RAYDP_TPU_FLASH_ONEPASS=0): the
//                         two-term update, which always rescales
//
// What bounds it on an H100. Prefill over T positions does 2*B*H*T^2*D
// operations (causal) on 4*B*H*T*D f32 elements: at T = 2048, D = 128 about
// 500 operations a byte, far above the card's ridge, so it is bound by
// operations: the FP32 pipes of the CUDA cores (67 TFLOP/s). Tensor cores
// stay out: TF32 wgmma rounds the operands and would break the bits below.
//
// What holds it back, and what the design does about it. The FP32 pipes
// take 128 FMAs a clock on an SM; shared memory gives 128 bytes a clock, and
// a warp's 16-byte load (LDS.128) takes four of those clocks whatever
// addresses its lanes share. A thread therefore needs about 4 FMAs for
// every float it loads from shared memory before the FP32 pipes, not shared
// memory, are the limit: a register tile of 8 x 8 outputs. The previous
// body (one warp a row, one key a lane) loaded one or two floats a FMA.
// This one stages a group of kGroup = 4 k-tiles (128 keys) at a time, so
// that a phase has enough outputs for register tiles of 8 x 4:
// - scores: threads 64t .. 64t + 63 take tile t, a thread 8 rows x 4 keys,
//   walking d ascending; per 4 d it loads 8 q and 4 k float4s for 128 FMAs;
// - softmax: four threads a row, each 8 of a tile's keys, the group's tiles
//   in order, in place in a [64][128] tile (scores in, p out); the row's m
//   and l stay in these threads' registers;
// - p.v: a thread holds 8 rows x 4 columns (4 x 4 at D 64) and walks each
//   tile's keys ascending; per 4 keys it loads 8 p and 4 V float4s for 128
//   FMAs; its running o stays in registers.
// That is 128 FMAs for 48 floats, 2.7 a float, short of 4: the scores and
// p.v still wait on shared memory (phase 1 of chip_smoke.py reports the
// SASS LDS:FFMA ratio), and 8 x 8 score tiles would need 256 keys of K
// staged, more shared memory than a block has.
// Row pitches of Q, K and the scores are padded by 16 bytes, so that the
// 8 keys (or rows) a quarter-warp reads at once fall in distinct banks.
// K and V arrive by 16-byte cp.async copies from every thread (zero-filled
// past Tk): the next group's K while this group's softmax and p.v run, a
// group's V while its scores run. cp.async fits this layout where TMA does
// not: TMA writes dense or 128-byte-swizzled boxes, not a padded pitch, and
// it would need a producer warp and mbarriers for tiles each thread copies
// in a few moves. A block's 197 KB (D 128) hold an SM alone; the grid runs
// the longest row blocks (the last ones, under a causal mask) first, so the
// card, which starts each next block on the SM that frees first, spreads
// the row blocks' unequal work evenly. A block stops at its last live tile
// and masks element by element only on tiles that some row of it does not
// see whole.
//
// Head dims. D 64 and 128 are the widths above. D 256 (bench.py's LM at
// d_model 2048, 8 heads) stages groups of kGroup = 2 tiles (64 keys): Q,
// K and V of 64 rows at the padded pitch and the [64][68] scores are 212
// KB, where four tiles would be 365 KB; a score tile of 32 keys then has
// 128 threads, each 4 rows x 4 keys, and p.v holds 16 rows x 4 columns a
// thread (64 accumulators), loading p 2 keys at a time. The rounding chain
// is the same. D 8, 16 and 32 (the small
// LMs' heads: d_model 32 over 4 or 2 heads, or 64 over 2) run the same
// body: a score tile's 128 FMAs then load 8 q and 4 k float4s per 4 d as
// before, p.v holds 1 (D 8, D 16) or 2 (D 32) rows x 4 columns a thread
// (at D 8 only the first 128 threads: 64 rows of 2 column quads), and a K
// tile is fewer 16-byte copies than the block has threads (copy_rows skips
// the rest). A block's 47 KB (D 8), 57 KB (D 16) or 77 KB (D 32) let
// several share an SM. Any other D up to 256 reaches this kernel
// zero-padded by the wrapper to the next of these widths (a zero column
// adds an exact 0 to each score's chain). The rounding chain below does
// not depend on D.
//
// Head dims past 256 (bench.py's LM at d_model 4096: 8 heads of 512) arrive
// zero-padded by the wrapper to a multiple of kHeadChunk (256) and run
// flash_fwd_chunked_kernel, the D 256 body with the same Layout (212 KB) and
// the same phases, plus a grid axis over the output's 256-column chunks:
// - scores: for each group, the block stages Q's and K's columns one
//   256-column chunk at a time (cp.async, waited before each chunk's
//   products), and each thread carries its 4 x 4 score chains from chunk to
//   chunk through its own slots of the score tile (no registers held while
//   the next chunk is staged), so every score is the one chain over d
//   ascending that D 256's body (and the decode) runs;
// - softmax: as at D 256; every column chunk's block computes the same m
//   and l, and the chunk-0 block writes them;
// - p.v: the group's V rows of the block's own 256 columns, as at D 256.
// The chunks' copies stay loops (copy_rows' kUnroll false): unrolled with a
// source pitch known only at run time, their row offsets held registers
// and ptxas spilled at 255; as loops the body takes 237, no spill.
// Each block recomputes the scores over all of D, so the blocks of a row
// block do D / 256 times the score work: (D / 256 + 1) / 2 times the
// operations of one pass (1.5 at D 512).
//
// Why the bits are kept. The split decode (flash_decode.cu) runs the steps
// of flash_common.cuh over the same 32-key tiles, merged in tile order, and
// an f32 decode row must equal the prefill row at its position bit for bit
// (the failover contract of docs/serving.md, "Determinism and failover").
// Which thread computes what is free; for every (row, tile) the rounding
// chain is the one of those steps:
// - each score one __fmaf_rn chain over d ascending, then __fmul_rn(s,
//   scale), or kNegInf where masked (tile_score);
// - the tile max by fmaxf (exact in any order);
// - p = expf(s - m_new) (tile_prob, the same expf);
// - p_sum in warp_sum's butterfly: keys j and j^16, then ^8, ^4 (inside a
//   thread: its keys of a tile are c + 4i), then ^2, ^1 (across the row's
//   four threads);
// - each p.v element one __fmaf_rn chain over keys 0..31 ascending
//   (tile_pv);
// - the merges by merge_term (rescale where the max moved, always in the
//   two-term body, else add; rows whose tile lies wholly in their future
//   skip it); tiles from key 0 in steps of kBlockK;
// - o = __fdiv_rn(acc, max(l, 1e-30)).
// The two-term body computes alpha = exp(m - m_new) and fma(alpha, acc, pv)
// on every tile; where the max did not move alpha is exp(0) == 1 exactly
// and fma(1, a, b) rounds like a + b, so it equals the one-pass body bit for
// bit. For bf16 q/k/v the prefill runs on the tensor cores with p rounded
// to bf16, so the decode row is within bf16 rounding of it, not bitwise.

#include "flash_common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kThreads = 256;  // 8 warps
// A row's entry in row_a for each tile of a group: alpha (>= 0) where the
// row max moved, kAdd where it did not, kSkip where the tile lies wholly in
// the row's future or the row is past T (no update).
constexpr float kAdd = -1.f;
constexpr float kSkip = -2.f;

// Shared memory of one block, in floats: Q, a group of K tiles, a group of
// V tiles, the group's scores (then p), row_a of each tile, and the final l
// of each row. Row pitches of Q, K and the scores are padded by 16 bytes.
template <int D>
struct Layout {
  static constexpr int kGroup = D > 128 ? 2 : 4;  // k-tiles staged together
  static constexpr int kGroupKeys = kGroup * kBlockK;
  static constexpr int kPitch = D + 4;            // Q and K rows
  static constexpr int kSPitch = kGroupKeys + 4;  // score / p rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRows * kPitch;
  static constexpr int kV = kK + kGroupKeys * kPitch;
  static constexpr int kS = kV + kGroupKeys * D;
  static constexpr int kA = kS + kRows * kSPitch;
  static constexpr int kL = kA + kGroup * kRows;
  static constexpr size_t kBytes = sizeof(float) * (kL + kRows);
  // p.v: a thread holds kPvRows rows (kPvGroups apart) x 4 columns; the
  // first kPvThreads threads take part (all of them from D 16)
  static constexpr int kColQuads = D / 4;
  static constexpr int kPvGroups =
      kThreads / kColQuads < kRows ? kThreads / kColQuads : kRows;
  static constexpr int kPvRows = kRows / kPvGroups;
  static constexpr int kPvThreads = kPvGroups * kColQuads;
  // scores: kTileThreads threads a tile, kScoreRows rows x 4 keys each
  static constexpr int kTileThreads = kThreads / kGroup;
  static constexpr int kRowGroups = kTileThreads / 8;
  static constexpr int kScoreRows = kRows / kRowGroups;
};

// N rows of D floats from `src` (row pitch `src_pitch` floats: D, or the
// padded head dim of the chunked body) into `dst` (row pitch `pitch`
// floats), 16 bytes a copy spread over the block; rows at or past `valid`
// are zeros. kUnroll false (the chunked body, whose source pitch is known
// only at run time) keeps the copies a loop.
template <int D, int N, bool kUnroll = true>
__device__ __forceinline__ void copy_rows(const float* src, int src_pitch,
                                          int valid, float* dst, int pitch) {
  constexpr int kPieces = D / 4;
  constexpr int kCopies = N * kPieces;  // fewer than the threads at D 16
  constexpr int kRounds = (kCopies + kThreads - 1) / kThreads;
  const auto copy = [&](int u) {
    const int i = threadIdx.x + u * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) return;
    const int r = i / kPieces;
    const int c = (i % kPieces) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * pitch + c,
               src + static_cast<size_t>(ok ? r : 0) * src_pitch + c, ok);
  };
  if constexpr (kUnroll) {
#pragma unroll
    for (int u = 0; u < kRounds; ++u) copy(u);
  } else {
#pragma unroll 1
    for (int u = 0; u < kRounds; ++u) copy(u);
  }
}

// Starts copying `n` tiles of rows from key kt0 of `src` (K or V, rows of
// `src_pitch` floats) into a group buffer at `dst` (row pitch `pitch`), as
// one cp.async group.
template <int D, bool kUnroll = true>
__device__ __forceinline__ void load_group(const float* src, int src_pitch,
                                           size_t kbase, int kt0, int n, int tk,
                                           float* dst, int pitch) {
  for (int t = 0; t < n; ++t) {
    const int key = kt0 + t * kBlockK;
    copy_rows<D, kBlockK, kUnroll>(src + (kbase + key) * src_pitch, src_pitch,
                                   tk - key, dst + t * kBlockK * pitch, pitch);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The kernel's arguments, as rtt_flash_fwd gives them.
struct FwdArgs {
  const float* q;  // [BH, T, D]
  const float* k;  // [BH, Tk, D]
  const float* v;
  float* o;        // [BH, T, D]
  float* m;        // [BH, T]
  float* l;
  int n_bh, t, tk, q_off, k_off, causal, normalize;
  float scale;
  int d_total;     // the chunked body's head dim (rows of q, k, v and o)
};

// Whether every key of the tile at kt0 is live for every row of the block.
__device__ __forceinline__ bool tile_full(const FwdArgs& a, int row0, int kt0) {
  return kt0 + kBlockK <= a.tk &&
         (!a.causal || a.q_off + row0 >= a.k_off + kt0 + kBlockK - 1);
}

// Scores of the group's live tiles: the kTileThreads threads from
// kTileThreads t on take tile t, thread (rg, g) rows rg + kRowGroups r (r <
// kScoreRows) x keys g + 8i (i < 4) of it (8 x 4 up to D 128, 4 x 4 at D
// 256). Each is one __fmaf_rn chain over d ascending, then the scale, or
// kNegInf where masked. Per 4 d a thread loads kScoreRows q and 4 k
// float4s for 16 kScoreRows FMAs. score_chains carries the chains `s` over
// the D staged columns of the group starting at key kt0; store_scores
// finishes them.
template <int D>
__device__ __forceinline__ void score_chains(
    const float* qs, const float* ks, int kt0,
    float (&s)[Layout<D>::kScoreRows][4]) {
  using L = Layout<D>;
  constexpr int kR = L::kScoreRows;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int g = threadIdx.x % 8;
  const float* qr = qs + rg * L::kPitch;
  const float* kr = ks + (tile * kBlockK + g) * L::kPitch;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 qa[kR], kb[4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      qa[r] = *reinterpret_cast<const float4*>(
          qr + L::kRowGroups * r * L::kPitch + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kb[i] = *reinterpret_cast<const float4*>(kr + 8 * i * L::kPitch + c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] = __fmaf_rn(part(qa[r], e), part(kb[i], e), s[r][i]);
        }
      }
    }
  }
}

// The finished chains of score_chains: scaled, or kNegInf where masked,
// into the group's score tile.
template <int D>
__device__ __forceinline__ void store_scores(
    const FwdArgs& a, const float (&s)[Layout<D>::kScoreRows][4], float* ss,
    int row0, int kt0) {
  using L = Layout<D>;
  constexpr int kR = L::kScoreRows;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int g = threadIdx.x % 8;
  const int tk0 = kt0 + tile * kBlockK;
  const bool full = tile_full(a, row0, tk0);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = rg + L::kRowGroups * r;
    const int q_pos = a.q_off + row0 + row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = g + 8 * i;
      const bool live = full || (tk0 + j < a.tk &&
                                 (!a.causal || q_pos >= a.k_off + tk0 + j));
      ss[row * L::kSPitch + tile * kBlockK + j] =
          live ? __fmul_rn(s[r][i], a.scale) : kNegInf;
    }
  }
}

// A thread's running score chains (score_chains' `s`) kept between the
// chunked body's column chunks in its own slots of the score tile, where
// store_scores puts them at the end (an f32 store and load change no bit):
// they hold no registers while the next chunk's Q and K are staged.
template <int D>
__device__ __forceinline__ void keep_chains(float* ss,
                                            float (&s)[Layout<D>::kScoreRows][4],
                                            bool load) {
  using L = Layout<D>;
  const int tile = threadIdx.x / L::kTileThreads;
  const int rg = (threadIdx.x / 8) % L::kRowGroups;
  const int g = threadIdx.x % 8;
#pragma unroll
  for (int r = 0; r < L::kScoreRows; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* at = ss + (rg + L::kRowGroups * r) * L::kSPitch + tile * kBlockK +
                  g + 8 * i;
      if (load) {
        s[r][i] = *at;
      } else {
        *at = s[r][i];
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void group_scores(const FwdArgs& a, const float* qs,
                                             const float* ks, float* ss,
                                             int row0, int kt0, int n_live) {
  using L = Layout<D>;
  if (threadIdx.x / L::kTileThreads >= n_live) return;
  float s[L::kScoreRows][4];
#pragma unroll
  for (int r = 0; r < L::kScoreRows; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
  }
  score_chains<D>(qs, ks, kt0, s);
  store_scores<D>(a, s, ss, row0, kt0);
}

// The softmax of the group's live tiles, in order, for row threadIdx.x / 4,
// whose four threads hold keys c + 4i (c = threadIdx.x % 4, i < 8) of each
// tile: the tile max, p in place of the scores, p_sum in warp_sum's order,
// and the row's (m, l) merged; row_a tells the p.v threads how to merge o.
template <int D, bool kTwoTerm>
__device__ __forceinline__ void group_softmax(const FwdArgs& a, float* ss,
                                              float* row_a, int row0, int rows,
                                              int kt0, int n_live, float& m,
                                              float& l) {
  using L = Layout<D>;
  const int r = threadIdx.x / 4;
  for (int tile = 0; tile < n_live; ++tile) {
    const bool skip = r >= rows ||
        (a.causal && a.q_off + row0 + r < a.k_off + kt0 + tile * kBlockK);
    float* sr = ss + r * L::kSPitch + tile * kBlockK + threadIdx.x % 4;
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = sr[4 * i];
    float tile_max = x[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) tile_max = fmaxf(tile_max, x[i]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = tile_prob(x[i], m_new);
      sr[4 * i] = x[i];
    }
    // keys j and j^16 (x[i], x[i + 4]), then j^8, then j^4 in the thread
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
      for (int i = 0; i < w; ++i) x[i] = __fadd_rn(x[i], x[i + w]);
    }
    // then j^2 and j^1: the row's threads are lanes 4 * (r % 8) + c
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], 2));
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(kFull, x[0], 1));
    const bool moved = kTwoTerm || tile_max > m;
    const float alpha = moved ? tile_alpha(m, m_new) : 1.f;
    if (!skip) {
      l = merge_term(moved, alpha, l, x[0]);
      m = m_new;
    }
    if (threadIdx.x % 4 == 0) {
      row_a[tile * kRows + r] = skip ? kSkip : moved ? alpha : kAdd;
    }
  }
}

// p.v of the group's live tiles, in order, merged into the thread's running
// o: thread (rg, cq) holds rows rg + kPvGroups * r (r < kPvRows) x columns
// 4cq .. 4cq + 3. Each element is one __fmaf_rn chain over a tile's keys
// ascending, then merge_term. Per 4 keys a thread loads kPvRows p and 4 V
// float4s for 16 * kPvRows FMAs (at D 256, per 2 keys kPvRows p float2s
// and 2 V float4s, which keeps p in 32 registers).
template <int D>
__device__ __forceinline__ void group_pv(const float* ps, const float* vs,
                                         const float* row_a, int n_live,
                                         float (&acc)[Layout<D>::kPvRows][4]) {
  using L = Layout<D>;
  constexpr int kR = L::kPvRows;
  if (threadIdx.x >= L::kPvThreads) return;  // D 8: rows past the block's
  const int rg = threadIdx.x / L::kColQuads;
  const int cq = threadIdx.x % L::kColQuads;
  for (int tile = 0; tile < n_live; ++tile) {
    const float* pt = ps + rg * L::kSPitch + tile * kBlockK;
    const float* vt = vs + tile * kBlockK * D + 4 * cq;
    constexpr int kJ = kR > 8 ? 2 : 4;  // keys of p loaded at once
    float pv[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[r][e] = 0.f;
    }
#pragma unroll
    for (int jb = 0; jb < kBlockK; jb += kJ) {
      float pj[kR][kJ];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float* src = pt + L::kPvGroups * r * L::kSPitch + jb;
        if constexpr (kJ == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          pj[r][0] = x.x, pj[r][1] = x.y, pj[r][2] = x.z, pj[r][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          pj[r][0] = x.x, pj[r][1] = x.y;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + (jb + jj) * D);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = pj[r][jj];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pv[r][e] = __fmaf_rn(p, part(vv, e), pv[r][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float alpha = row_a[tile * kRows + rg + L::kPvGroups * r];
      if (alpha == kSkip) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][e] = merge_term(alpha >= 0.f, alpha, acc[r][e], pv[r][e]);
      }
    }
  }
}

// The block's rows out: m and l (where `write_ml`) and o, normalized or
// not, into columns [col0, col0 + D) of rows `pitch` floats apart.
template <int D>
__device__ __forceinline__ void write_rows(const FwdArgs& a, float* smem,
                                           size_t qbase, int row0, int rows,
                                           float m, float l,
                                           const float (&acc)[Layout<D>::kPvRows][4],
                                           int pitch, int col0, bool write_ml) {
  using L = Layout<D>;
  if (threadIdx.x % 4 == 0) {
    const int r = threadIdx.x / 4;
    smem[L::kL + r] = l;
    if (r < rows && write_ml) {
      a.m[qbase + row0 + r] = m;
      a.l[qbase + row0 + r] = l;
    }
  }
  __syncthreads();
  const int rg = threadIdx.x / L::kColQuads;
  const int cq = threadIdx.x % L::kColQuads;
#pragma unroll
  for (int r = 0; r < L::kPvRows; ++r) {
    const int row = rg + L::kPvGroups * r;
    if (row >= rows) continue;
    const float denom = fmaxf(smem[L::kL + row], 1e-30f);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = a.normalize ? __fdiv_rn(acc[r][e], denom) : acc[r][e];
    }
    *reinterpret_cast<float4*>(a.o + (qbase + row0 + row) * pitch + col0 +
                               4 * cq) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Rows [row0, row0 + 64) of bh: Q staged once, then the K/V tiles that any
// of its rows sees, kGroup at a time: scores, softmax tile after tile, p.v
// tile after tile; then m, l and o. K of the next group loads while this
// group's softmax and p.v run, V of a group while its scores run.
template <int D, bool kTwoTerm>
__device__ __forceinline__ void row_block(const FwdArgs& a, size_t bh,
                                          int row0, float* smem) {
  using L = Layout<D>;
  const int rows = min(kRows, a.t - row0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  constexpr int kGroup = L::kGroup;
  constexpr int kGroupKeys = L::kGroupKeys;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int n_groups = (n_tiles + kGroup - 1) / kGroup;

  float m = kNegInf;  // the softmax threads' row
  float l = 0.f;
  float acc[L::kPvRows][4];  // the p.v threads' rows and columns
#pragma unroll
  for (int r = 0; r < L::kPvRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  if (n_tiles > 0) {  // Q joins group 0's K
    copy_rows<D, kRows>(a.q + (qbase + row0) * D, D, rows, smem + L::kQ,
                        L::kPitch);
    load_group<D>(a.k, D, kbase, 0, min(kGroup, n_tiles), a.tk, smem + L::kK,
                  L::kPitch);
  }
  for (int gi = 0; gi < n_groups; ++gi) {
    const int kt0 = gi * kGroupKeys;
    const int n_live = min(kGroup, n_tiles - gi * kGroup);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this group's K is in; the last group's p.v is done
    load_group<D>(a.v, D, kbase, kt0, n_live, a.tk, smem + L::kV, D);
    group_scores<D>(a, smem + L::kQ, smem + L::kK, smem + L::kS, row0, kt0,
                    n_live);
    __syncthreads();  // the scores are in; K is free
    const bool more = gi + 1 < n_groups;
    if (more) {
      load_group<D>(a.k, D, kbase, kt0 + kGroupKeys,
                    min(kGroup, n_tiles - (gi + 1) * kGroup), a.tk,
                    smem + L::kK, L::kPitch);
    }
    group_softmax<D, kTwoTerm>(a, smem + L::kS, smem + L::kA, row0, rows, kt0,
                               n_live, m, l);
    if (more) {  // the next K may stay in flight
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // p, row_a and this group's V are in
    group_pv<D>(smem + L::kS, smem + L::kV, smem + L::kA, n_live, acc);
  }

  write_rows<D>(a, smem, qbase, row0, rows, m, l, acc, D, 0, true);
}

// The chunked body (head dims past 256, d_total = n * kHeadChunk): rows
// [row0, row0 + 64) of bh and output columns [col0, col0 + 256), in D
// 256's Layout. For each group of 2 k-tiles: the group's V columns start
// loading; then, one 256-column chunk at a time, Q's and K's columns are
// staged and every live score thread carries its chains through them; then
// the scores are stored, the softmax and p.v run as at D 256.
template <bool kTwoTerm>
__device__ __forceinline__ void row_block_chunked(const FwdArgs& a, size_t bh,
                                                  int row0, int col0,
                                                  float* smem) {
  constexpr int D = kHeadChunk;
  using L = Layout<D>;
  const int dt = a.d_total;
  const int n_dc = dt / D;
  const int rows = min(kRows, a.t - row0);
  const size_t qbase = bh * a.t;
  const size_t kbase = bh * a.tk;
  int k_end = a.tk;  // keys [0, k_end) can be live for some row of the block
  if (a.causal) k_end = max(0, min(a.tk, a.q_off + row0 + rows - a.k_off));
  constexpr int kGroup = L::kGroup;
  constexpr int kGroupKeys = L::kGroupKeys;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int n_groups = (n_tiles + kGroup - 1) / kGroup;

  float m = kNegInf;  // the softmax threads' row
  float l = 0.f;
  float acc[L::kPvRows][4];  // the p.v threads' rows and columns
#pragma unroll
  for (int r = 0; r < L::kPvRows; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }

  for (int gi = 0; gi < n_groups; ++gi) {
    const int kt0 = gi * kGroupKeys;
    const int n_live = min(kGroup, n_tiles - gi * kGroup);
    const bool live_tile = threadIdx.x / L::kTileThreads < n_live;
    __syncthreads();  // the last group's p.v and scores are done
    load_group<D, false>(a.v + col0, dt, kbase, kt0, n_live, a.tk,
                         smem + L::kV, D);
    for (int dc = 0; dc < n_dc; ++dc) {
      if (dc > 0) __syncthreads();  // the last chunk's Q and K are read
      copy_rows<D, kRows, false>(a.q + (qbase + row0) * dt + dc * D, dt, rows,
                                 smem + L::kQ, L::kPitch);
      load_group<D, false>(a.k + dc * D, dt, kbase, kt0, n_live, a.tk,
                           smem + L::kK, L::kPitch);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // this chunk's Q and K (and the group's V) are in
      if (!live_tile) continue;
      float s[L::kScoreRows][4];
      if (dc == 0) {
#pragma unroll
        for (int r = 0; r < L::kScoreRows; ++r) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
        }
      } else {
        keep_chains<D>(smem + L::kS, s, true);
      }
      score_chains<D>(smem + L::kQ, smem + L::kK, kt0, s);
      if (dc + 1 < n_dc) {
        keep_chains<D>(smem + L::kS, s, false);
      } else {
        store_scores<D>(a, s, smem + L::kS, row0, kt0);
      }
    }
    __syncthreads();  // the scores are in
    group_softmax<D, kTwoTerm>(a, smem + L::kS, smem + L::kA, row0, rows, kt0,
                               n_live, m, l);
    __syncthreads();  // p and row_a are in
    group_pv<D>(smem + L::kS, smem + L::kV, smem + L::kA, n_live, acc);
  }
  write_rows<D>(a, smem, qbase, row0, rows, m, l, acc, dt, col0, col0 == 0);
}

// Prefill: one block per (bh, 64 query rows), the longest row blocks first:
// block b takes row block n_row_blocks - 1 - b / n_bh of bh b % n_bh. One
// block holds an SM, so the card starts each next block on the SM that
// frees first: the longest-first order then spreads the causal row blocks'
// unequal work evenly.
template <int D, bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const int row_block_index =
      n_row_blocks - 1 - static_cast<int>(blockIdx.x / a.n_bh);
  row_block<D, kTwoTerm>(a, blockIdx.x % a.n_bh, row_block_index * kRows,
                         smem);
}

// The chunked body: one block per (bh, 64 query rows, 256 output columns),
// the longest row blocks first, as flash_fwd_kernel orders them.
template <bool kTwoTerm>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_chunked_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_row_blocks = (a.t + kRows - 1) / kRows;
  const int per_row_block = a.n_bh * (a.d_total / kHeadChunk);
  const int row_block_index =
      n_row_blocks - 1 - static_cast<int>(blockIdx.x / per_row_block);
  const int rest = static_cast<int>(blockIdx.x % per_row_block);
  row_block_chunked<kTwoTerm>(a, rest % a.n_bh, row_block_index * kRows,
                              (rest / a.n_bh) * kHeadChunk, smem);
}

// d: a multiple of kHeadChunk past it.
int launch_fwd_chunked(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int bh, int t, int tk, int d,
                       int q_off, int k_off, int causal, int normalize,
                       int onepass, float scale, cudaStream_t stream) {
  using L = Layout<kHeadChunk>;
  auto kernel = onepass ? flash_fwd_chunked_kernel<false>
                        : flash_fwd_chunked_kernel<true>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((t + kRows - 1) / kRows) *
                           bh * (d / kHeadChunk);
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o),
                     m, l, bh, t, tk, q_off, k_off, causal, normalize, scale,
                     d};
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* m,
               float* l, int bh, int t, int tk, int q_off, int k_off,
               int causal, int normalize, int onepass, float scale,
               cudaStream_t stream) {
  using L = Layout<D>;
  // one block an SM from D 64: more than half of an H100 SM's 228 KB (at D
  // 8, 16 and 32, 47, 57 and 77 KB, several blocks share an SM; at D 256,
  // 212 KB)
  static_assert(D < 64 || L::kBytes > 116 * 1024,
                "a second block would fit an SM");
  auto kernel =
      onepass ? flash_fwd_kernel<D, false> : flash_fwd_kernel<D, true>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((t + kRows - 1) / kRows) * bh;
  if (blocks <= 0 || blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(o),
                     m, l, bh, t, tk, q_off, k_off, causal, normalize, scale};
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 forward on tensor cores (flash_forward_sm90.cu).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int t, int tk, int d, int q_off,
                   int k_off, int causal, int normalize, int out_f32,
                   int onepass, float scale, cudaStream_t stream);

extern "C" {

const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success); an unsupported
// head dim or dtype returns cudaErrorInvalidValue without launching. The
// head dims built (each entry's `case`s, which
// ops/flash_attention.py KERNEL_HEAD_DIMS lists): 8, 16, 32, 64, 128 and
// 256; a multiple of kHeadChunk past 256 runs the chunked body.
// onepass = 0 launches the two-term body (flash_fwd_twoterm). bf16 goes to
// the tensor-core forward, f32 to flash_fwd_kernel (o is f32 either way, so
// out_f32 changes nothing there). q, k and v must be 16-byte aligned.
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* m, float* l, int bh, int t, int tk, int d, int dtype,
                  int q_off, int k_off, int causal, int normalize, int out_f32,
                  int onepass, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    return flash_fwd_sm90(q, k, v, o, m, l, bh, t, tk, d, q_off, k_off, causal,
                          normalize, out_f32, onepass, scale, s);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
#define RTT_FWD(D)                                                         \
  return launch_fwd<D>(q, k, v, o, m, l, bh, t, tk, q_off, k_off, causal, \
                       normalize, onepass, scale, s)
  switch (d) {
    case 8: RTT_FWD(8);
    case 16: RTT_FWD(16);
    case 32: RTT_FWD(32);
    case 64: RTT_FWD(64);
    case 128: RTT_FWD(128);
    case 256: RTT_FWD(256);
  }
#undef RTT_FWD
  if (d > kHeadChunk && d % kHeadChunk == 0) {
    return launch_fwd_chunked(q, k, v, o, m, l, bh, t, tk, d, q_off, k_off,
                              causal, normalize, onepass, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
